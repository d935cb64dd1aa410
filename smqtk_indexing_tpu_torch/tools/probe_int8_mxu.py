"""
The int8 x int8 stage-1 probe on one CUDA card: the port's counterpart of
``tools/probe_int8_mxu.py`` (K10, ``scan_minima`` -> ``_kernel``).

Does the SQ8 stage-1 scan pay for quantising the query to int8 as well,
so that both operands are int8? The probe answers it in one process, on
16,777,216 x 128 int8 codes (2.1 GB) made on the card from a
``torch.Generator`` seeded with 0, in K10's (d, N) layout, B = 128:

1. rank agreement: the segment top-32 of the int8 x int8 minima against
   those of the bf16-query minima (mean and min overlap over queries);
2. the A/B: CUDA-event milliseconds of a pass of each arm, pipelined 8
   passes deep, best of 3, and the speedup.

    python -m smqtk_indexing_tpu_torch.tools.probe_int8_mxu

prints one JSON line for each. It needs a card and raises without one.

:func:`scan_minima` is K10's function: the (d, N) layout is the tiled
layout with a single tile, so it runs K2's tensor-core kernel
(``csrc/segment_minima_tiled_wgmma.cu``) over ``db_t[None]``: the int8 x
int8 form (``wgmma`` s8) with the query's scale ``g`` (``(sq - 2
(float(<q, x>) g)) + pen``, the order of ``probe_int8_mxu.py:51-59``), or
the int8-code form against a bf16-rounded query (``wgmma`` bf16).
:func:`scan_minima_reference` is its plain version.
"""
from __future__ import annotations

import json

import torch

from smqtk_indexing_tpu_torch.ops import fused_scan
from smqtk_indexing_tpu_torch.ops.device import resolve_device

#: Segment width and the probe's shape (the JAX probe's ``SEG``, ``TILE_N``
#: and ``n = TILE_N * 4096``; the port keeps its own copies).
SEG = 128
TILE_N = 4096
D = 128
B = 128
N = TILE_N * 4096
#: Segments each query keeps, for the rank agreement.
S_KEEP = 32
#: The A/B's timed rounds and the passes pipelined in each (the JAX
#: probe's ``reps`` and ``depth``, ``probe_int8_mxu.py:145``).
REPS = 3
DEPTH = 8

#: Launches of K10's kernels by arm; the wrapper adds one where it
#: launches and nowhere else.
LAUNCHES = {"int8dot": 0, "bf16": 0}


def _check(db_t, sq, pen, q, int8dot: bool) -> torch.Tensor:
    """Check the operands; return the query the kernels take (int8, or
    f32 for the bf16 arm)."""
    if db_t.dim() != 2 or db_t.dtype != torch.int8:
        raise ValueError(f"scan_minima: db_t must be (d, N) int8, got "
                         f"{tuple(db_t.shape)} {db_t.dtype}")
    if int8dot != (q.dtype == torch.int8):
        raise TypeError("scan_minima: int8dot takes an int8 query, the "
                        f"bf16 arm a float one; got {q.dtype}")
    qk = q if int8dot else q.float()
    fused_scan.check_tiled(db_t[None], sq, pen, qk, "scan_minima")
    return qk


def scan_minima(db_t: torch.Tensor, sq: torch.Tensor, pen: torch.Tensor,
                q: torch.Tensor, g, *, int8dot: bool) -> torch.Tensor:
    """
    K10: per-query, per-128-row segment minima of ``(sq - 2 ip) + pen``
    over a (d, N) int8 database, where ``ip`` is ``float(<q_i8, x>) * g``
    for an int8 query (``int8dot``) and ``<bf16(q), x>`` otherwise.

    :param db_t: (d, N) int8 codes, N % 128 == 0.
    :param sq, pen: (N,) or (1, N) f32 row stats and penalty.
    :param q: (B, d): int8 for ``int8dot``, else f32 or bf16.
    :param g: the int8 query's scale (a float or a one-element tensor);
        the bf16 arm ignores it.
    :return: (B, N // 128) f32, in segment order (``probe_int8_mxu.py:94``).
    :raises RuntimeError: on CUDA tensors, if the kernel cannot be built or
        launched. There is no fallback to the plain version.
    """
    qk = _check(db_t, sq, pen, q, int8dot)
    if db_t.device.type == "cpu":
        return scan_minima_reference(db_t, sq, pen, q, g, int8dot=int8dot)
    nseg = db_t.shape[1] // SEG
    out, _, _ = fused_scan.tiled_cuda(db_t[None], sq.reshape(-1),
                                      pen.reshape(-1), qk, nseg, 1,
                                      scale=float(g))
    LAUNCHES["int8dot" if int8dot else "bf16"] += 1
    return out[0]


def scan_minima_reference(db_t: torch.Tensor, sq: torch.Tensor,
                          pen: torch.Tensor, q: torch.Tensor, g, *,
                          int8dot: bool) -> torch.Tensor:
    """The plain PyTorch version of :func:`scan_minima`: column chunks of
    f32 scores under ``fused_scan.REFERENCE_BYTES``, each reduced to its
    segment minima at once. The int8 products are integers below 2^24,
    so f32 sums them exactly, and the result equals the kernel's bit for
    bit."""
    _check(db_t, sq, pen, q, int8dot)
    sq, pen = sq.reshape(-1), pen.reshape(-1)
    if not int8dot:
        return fused_scan.segment_minima_tiled_reference(db_t[None], sq, pen,
                                                         q.float())
    d, n = db_t.shape
    b = q.shape[0]
    g32 = torch.tensor(float(g), dtype=torch.float32, device=db_t.device)
    qf = q.float()
    out = torch.empty((b, n // SEG), dtype=torch.float32, device=db_t.device)
    cols = max(SEG, fused_scan.REFERENCE_BYTES // (4 * max(b, 1)) // SEG
               * SEG)
    for lo in range(0, n, cols):
        hi = min(lo + cols, n)
        ip = qf @ db_t[:, lo:hi].float()
        s = (sq[lo:hi] - 2.0 * (ip * g32)) + pen[lo:hi]
        out[:, lo // SEG:hi // SEG] = s.view(b, -1, SEG).amin(dim=-1)
    return out


def quantise(qf: torch.Tensor):
    """The probe's int8 query (``probe_int8_mxu.py:121-124``): one global
    scale ``g = max|q| / 127`` and ``clip(rint(q / g), -127, 127)``.

    :return: (q_i8 (B, d) int8, g as a float that is exact in f32)."""
    g = (qf.abs().max() / 127.0).item()
    q_i8 = torch.clamp(torch.round(qf / g), -127, 127).to(torch.int8)
    return q_i8, g


def make_inputs(device="cuda", n: int = N, b: int = B, seed: int = 0
                ) -> dict:
    """The probe's operands on ``device``: (d, n) int8 codes uniform in
    [-127, 127] and (b, d) normal f32 queries from one ``torch.Generator``
    seeded with ``seed``; ``sq`` the codes' squared norms, ``pen`` zeros;
    the bf16-rounded and the int8 query with its scale.

    :raises RuntimeError: ``device`` is a CUDA device and no card is
        present.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    db_t = torch.empty((D, n), dtype=torch.int8, device=dev)
    db_t.random_(-127, 128, generator=gen)
    qf = torch.randn((b, D), generator=gen, device=dev)
    sq = torch.empty((n,), dtype=torch.float32, device=dev)
    step = 1 << 20                   # f32 temporaries of 512 MB at most
    for lo in range(0, n, step):
        sq[lo:lo + step] = (db_t[:, lo:lo + step].float() ** 2).sum(0)
    q_i8, g = quantise(qf)
    return {"db_t": db_t, "sq": sq, "pen": torch.zeros_like(sq),
            "q_bf": qf.to(torch.bfloat16).float(), "q_i8": q_i8, "g": g}


def overlap(m_a: torch.Tensor, m_b: torch.Tensor, s_keep: int = S_KEEP
            ) -> torch.Tensor:
    """Per query, the share of the ``s_keep`` smallest segments of ``m_a``
    that are also among those of ``m_b``."""
    top_a = torch.topk(m_a, s_keep, dim=1, largest=False).indices
    top_b = torch.topk(m_b, s_keep, dim=1, largest=False).indices
    hit = (top_a[:, :, None] == top_b[:, None, :]).any(-1)
    return hit.float().mean(dim=1)


def _emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def run(inputs: dict, reps: int = REPS, depth: int = DEPTH) -> dict:
    """The probe on ``inputs`` (from :func:`make_inputs`, on a card):
    rank agreement of the two arms, then each arm's milliseconds a pass,
    pipelined ``depth`` passes deep between two CUDA events, best of
    ``reps``; one JSON line each.

    :return: the numbers printed.
    :raises ValueError: the inputs are not on a CUDA device.
    """
    db_t = inputs["db_t"]
    if db_t.device.type != "cuda":
        raise ValueError("the probe times with CUDA events: its inputs must "
                         "be on a CUDA device")
    sq, pen, g = inputs["sq"], inputs["pen"], inputs["g"]
    arms = {"int8dot": (inputs["q_i8"], True), "bf16": (inputs["q_bf"],
                                                          False)}
    m = {arm: scan_minima(db_t, sq, pen, q, g, int8dot=i8)
         for arm, (q, i8) in arms.items()}
    agree = overlap(m["int8dot"], m["bf16"])
    res = {"overlap_mean": agree.mean().item(),
           "overlap_min": agree.min().item()}
    _emit(metric="probe_int8_overlap", s_keep=S_KEEP, rows=db_t.shape[1],
          b=inputs["q_i8"].shape[0], mean=res["overlap_mean"],
          min=res["overlap_min"])
    del m

    def bench(arm: str, n_reps: int, n_depth: int) -> float:
        q, i8 = arms[arm]
        best = float("inf")
        for _ in range(n_reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n_depth):
                scan_minima(db_t, sq, pen, q, g, int8dot=i8)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / n_depth)
        return best

    for arm in arms:                                        # warm-up
        bench(arm, 1, 2)
    gb = db_t.numel() / 1e9
    for arm in ("bf16", "int8dot"):
        ms = bench(arm, reps, depth)
        res[f"{arm}_ms"] = ms
        _emit(metric="probe_int8_ms", arm=arm, ms=ms, gb_s=gb / (ms / 1e3),
              device=torch.cuda.get_device_name(db_t.device))
    res["speedup"] = res["bf16_ms"] / res["int8dot_ms"]
    _emit(metric="probe_int8_speedup", value=res["speedup"],
          verdict="LAND IT" if res["speedup"] >= 1.15 else "not worth it")
    return res


def main() -> dict:
    return run(make_inputs("cuda"))


if __name__ == "__main__":
    main()
