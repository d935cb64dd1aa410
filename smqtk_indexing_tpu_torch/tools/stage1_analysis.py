"""
The stage-1 decomposition probe on one CUDA card: the port's counterpart of
``tools/stage1_analysis.py`` (K9, ``_run_variant`` -> ``_variant_kernel``).

Where does the time of the capacity scan's stage 1 go: the products, the
segment-minimum epilogue, or the bytes? Each variant runs production's
stage 1 on the tensor cores (``csrc/segment_minima_tiled_wgmma.cu``, the
kernel of K2, K4 and K5) with its epilogue changed, so that the
differences between their times split it:

- ``full``: the production stage 1 (K2's instantiation itself, writing
  K5's step-major minima);
- ``folded``: no penalty (one score operand fewer);
- ``nomin``: the first tile_n / 128 scores of each tile written in place of
  the segment minima (the products stay, the minimum goes);
- ``nodot``: no products (``sq - 2 x[r, 0] + pen`` for every query; the
  codes are still staged through shared memory), the minimum stays:
  bytes, staging and epilogue;
- ``bf16min``: each score rounded to bf16 before the minimum;
- ``staged``, ``minfirst``: TPU instruction orders whose output is
  ``full``'s bit for bit; the port runs ``full``'s kernel for them and
  says so (``"same_as": "full"``).

:func:`run_variant` returns a variant's whole (n_steps, B, t_step * tile_n
/ 128) output, K5's step-major layout, and :func:`sum_first_column` the
scalar the JAX probe reduces it to. On a CUDA tensor it runs the
variant's instantiation of ``csrc/segment_minima_tiled_wgmma.cu`` through
``fused_scan.tiled_cuda``, the launcher of K2, K4 and K5; on a CPU tensor
:func:`run_variant_reference`.
The query is f32 (rounded to bf16 over the int8 codes, as the JAX probe's
main() runs it: ``wgmma`` bf16) or int8 (the int8 x int8 form, ``wgmma``
s8).

    python -m smqtk_indexing_tpu_torch.tools.stage1_analysis \\
        [--n-tiles 24576] [--reps 3] [--variants full,nodot]

builds the capacity layout (24,576 tiles of (128, 4096) int8, 12.9 GB) on
the card from a ``torch.Generator`` seeded with 0 and prints, as JSON
lines, the card's ideal times (``stage1_ideal``), the production K2 and
K5 times and each variant x t_step in {2, 4, 8}'s milliseconds and GB/s.
It needs a card and raises without one.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from smqtk_indexing_tpu_torch.ops import fused_scan
from smqtk_indexing_tpu_torch.ops.device import resolve_device

#: The JAX probe's shapes (its ``SEG``, ``TILE_N``, ``D``, ``B``; the port
#: keeps its own copies).
SEG = 128
TILE_N = 4096
D = 128
B = 128
N_TILES = 24576
T_STEPS = (2, 4, 8)
#: Peaks of one H100 SXM (NVIDIA's data sheet): device memory bytes/s and
#: dense tensor-core rates of bf16 and int8.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12

#: Each variant's epilogue in ``csrc/segment_minima_tiled_wgmma.cu``
#: (``Variant``).
KERNEL_VARIANT = {"full": 0, "folded": 1, "nomin": 2, "nodot": 3,
                  "bf16min": 4, "staged": 0, "minfirst": 0}
VARIANTS = tuple(KERNEL_VARIANT)
#: Variants whose output is another's bit for bit, run by its kernel.
SAME_AS = {"staged": "full", "minfirst": "full"}

#: Launches of K9's kernel by the variant it ran; the wrapper adds one
#: where it launches and nowhere else.
LAUNCHES = {v: 0 for v in VARIANTS if v not in SAME_AS}


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place of each value: 2^(e - 8) for |v| in
    [2^(e - 1), 2^e), 0 at 0. ``bf16min``'s allowance against its plain
    version: a score summed in f32 in another order and then rounded to
    bf16 may land on the neighbouring bf16 (127.6 -> 127.5 or 128.0)."""
    return torch.ldexp(torch.ones_like(v), torch.frexp(v)[1] - 8) * (v != 0)


def steps(n_tiles: int, t_step: int) -> int:
    """``t_step`` halved until it divides ``n_tiles``
    (``stage1_analysis.py:171-172``)."""
    while n_tiles % t_step:
        t_step //= 2
    return t_step


def _check(db3, db_sq, penalty, q, variant: str) -> None:
    if variant not in KERNEL_VARIANT:
        raise ValueError(f"unknown stage-1 variant {variant!r}; one of "
                         f"{VARIANTS}")
    if db3.dim() != 3 or db3.dtype != torch.int8:
        raise ValueError("run_variant: db3 must be the (n_tiles, d, tile_n) "
                         "int8 tiled layout")
    fused_scan.check_tiled(db3, db_sq, penalty, q, "run_variant")


def run_variant(db3: torch.Tensor, db_sq: torch.Tensor,
                penalty: torch.Tensor, q: torch.Tensor, *, variant: str,
                t_step: int) -> torch.Tensor:
    """
    K9: one stage-1 variant over the tiled layout.

    :param db3: (n_tiles, d, tile_n) int8 codes, tile_n % 128 == 0.
    :param db_sq, penalty: N f32 values each, in row order.
    :param q: (B, d) f32 (rounded to bf16 for the products) or int8.
    :param variant: one of :data:`VARIANTS`.
    :param t_step: tiles a step, halved until it divides n_tiles; it sets
        the output layout only.
    :return: (n_tiles / t_step, B, t_step * tile_n / 128) f32.
    :raises ValueError: on CUDA tensors, a variant other than ``full`` (and
        those run as it) given more than :data:`B` queries.
    :raises RuntimeError: on CUDA tensors, if the kernel cannot be built or
        launched. There is no fallback to the plain version.
    """
    _check(db3, db_sq, penalty, q, variant)
    if db3.device.type == "cpu":
        return run_variant_reference(db3, db_sq, penalty, q,
                                     variant=variant, t_step=t_step)
    n_tiles, _, tile_n = db3.shape
    kv = KERNEL_VARIANT[variant]
    if kv == KERNEL_VARIANT["nomin"] and tile_n > SEG * SEG:
        raise ValueError(f"run_variant: nomin takes tile_n <= {SEG * SEG}")
    if kv != KERNEL_VARIANT["full"] and q.shape[0] > B:
        # Built for the probe's plan only (B <= 128, the query resident).
        raise ValueError(f"run_variant: {variant} takes at most {B} "
                         "queries")
    g = steps(n_tiles, t_step) * tile_n // SEG
    out, _, _ = fused_scan.tiled_cuda(db3, db_sq.reshape(-1),
                                      penalty.reshape(-1), q, g, 1,
                                      variant=kv)
    LAUNCHES[SAME_AS.get(variant, variant)] += 1
    return out


def _scores(rows: torch.Tensor, sq: torch.Tensor, pen: torch.Tensor,
            qk: torch.Tensor) -> torch.Tensor:
    """(B, R) f32 scores ``(sq - 2 <q, x>) + pen`` of (R, d) rows."""
    return (sq - 2.0 * (qk @ rows.float().T)) + pen


def run_variant_reference(db3: torch.Tensor, db_sq: torch.Tensor,
                          penalty: torch.Tensor, q: torch.Tensor, *,
                          variant: str, t_step: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`run_variant`, each variant as
    ``stage1_analysis.py:67-162`` computes it, over chunks of tiles under
    ``fused_scan.REFERENCE_BYTES`` of scores."""
    _check(db3, db_sq, penalty, q, variant)
    variant = SAME_AS.get(variant, variant)
    n_tiles, d, tile_n = db3.shape
    b = q.shape[0]
    nseg_t = tile_n // SEG
    g = steps(n_tiles, t_step) * nseg_t
    sq, pen = db_sq.reshape(-1), penalty.reshape(-1)
    qk = fused_scan._q_kernel_dtype(q, db3.dtype).float()
    out = torch.empty((b, n_tiles * nseg_t), dtype=torch.float32,
                      device=db3.device)
    chunk = max(1, fused_scan.REFERENCE_BYTES // (4 * max(b, 1) * tile_n))
    for t0 in range(0, n_tiles, chunk):
        t1 = min(t0 + chunk, n_tiles)
        lo, hi = t0 * tile_n, t1 * tile_n
        rows = db3[t0:t1].transpose(1, 2).reshape(-1, d)
        if variant == "nodot":
            s = ((sq[lo:hi] - 2.0 * rows[:, 0].float()) + pen[lo:hi]) \
                .expand(b, -1)
        elif variant == "nomin":
            first = torch.arange(t1 - t0, device=db3.device)[:, None] \
                * tile_n + torch.arange(nseg_t, device=db3.device)
            first = first.reshape(-1)
            out[:, t0 * nseg_t:t1 * nseg_t] = _scores(
                rows[first], sq[lo:hi][first], pen[lo:hi][first], qk)
            continue
        elif variant == "folded":
            s = sq[lo:hi] - 2.0 * (qk @ rows.float().T)
        else:
            s = _scores(rows, sq[lo:hi], pen[lo:hi], qk)
        if variant == "bf16min":
            s = s.to(torch.bfloat16)
        out[:, t0 * nseg_t:t1 * nseg_t] = \
            s.reshape(b, -1, SEG).amin(dim=-1).float()
    return out.view(b, -1, g).transpose(0, 1).contiguous()


def sum_first_column(out: torch.Tensor) -> torch.Tensor:
    """The scalar the JAX probe reduces a variant's output to
    (``stage1_analysis.py:196-198``): ``sum(out[:, :, 0])``."""
    return out[:, :, 0].sum()


def _emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def _cuda_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ideal(n: int, b: int) -> dict:
    """This card's least times for the stage's codes and products: the
    int8 codes (n x D bytes) at 3.35 TB/s, the 2 b n D products at the
    bf16 and int8 tensor-core rates."""
    dma_ms = n * D / HBM_BYTES_S * 1e3
    bf16_ms = 2.0 * b * n * D / BF16_FLOPS * 1e3
    int8_ms = 2.0 * b * n * D / INT8_OPS * 1e3
    return {"dma_ms": dma_ms, "tc_bf16_ms": bf16_ms, "tc_int8_ms": int8_ms,
            "ideal_overlapped_ms": max(dma_ms, bf16_ms)}


def sweep(db3: torch.Tensor, db_sq: torch.Tensor, penalty: torch.Tensor,
          q: torch.Tensor, reps: int = 3,
          variants: Sequence[str] = VARIANTS,
          t_steps: Sequence[int] = T_STEPS) -> list:
    """Time each variant x t_step on the card (one warm-up call, then the
    mean of ``reps`` calls between two CUDA events) and print a JSON line
    for each: its ms and the codes' GB/s.

    :return: the printed rows.
    :raises ValueError: the index is not on a CUDA device.
    """
    if db3.device.type != "cuda":
        raise ValueError("sweep() times with CUDA events: the index must "
                         "be on a CUDA device")
    gb = db3.numel() / 1e9
    rows = []
    for variant in variants:
        for t_step in t_steps:
            def fn():
                return run_variant(db3, db_sq, penalty, q, variant=variant,
                                   t_step=t_step)
            fn()                                           # warm-up
            ms = _cuda_ms(fn, reps)
            row = {"metric": f"stage1_{variant}_t{t_step}_ms", "value": ms,
                   "gb_s": gb / (ms / 1e3),
                   "query": "int8" if q.dtype == torch.int8 else "bf16"}
            if variant in SAME_AS:
                row["same_as"] = SAME_AS[variant]
            _emit(**row)
            rows.append(row)
    return rows


def build(n_tiles: int = N_TILES, device="cuda", seed: int = 0):
    """The probe's operands (``stage1_analysis.py:212-232``): (n_tiles, D,
    TILE_N) int8 codes uniform in [-127, 127], filled in place a chunk of
    tiles at a time from a ``torch.Generator`` seeded with ``seed``; db_sq
    ones, penalty zeros; (B, D) normal queries times 8.

    :raises RuntimeError: ``device`` is a CUDA device and no card is
        present.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    db3 = torch.empty((n_tiles, D, TILE_N), dtype=torch.int8, device=dev)
    for t0 in range(0, n_tiles, 512):
        db3[t0:t0 + 512].random_(-127, 128, generator=gen)
    n = n_tiles * TILE_N
    q = torch.randn((B, D), generator=gen, device=dev) * 8
    return db3, torch.ones(n, device=dev), torch.zeros(n, device=dev), q


def main(argv: Optional[list] = None) -> list:
    # The JAX probe's three arguments (its argv[1:4], stage1_analysis.py:27,
    # 203-205, 269-271), as flags.
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-tiles", type=int, default=N_TILES,
                    help="tiles of 4096 rows (the JAX probe's argv[1])")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed calls a configuration (its argv[2])")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated subset to sweep (its argv[3])")
    args = ap.parse_args(argv)
    variants = tuple(args.variants.split(","))
    for v in variants:
        if v not in KERNEL_VARIANT:
            raise ValueError(f"unknown stage-1 variant {v!r}")
    db3, db_sq, penalty, q = build(args.n_tiles, "cuda")
    n = args.n_tiles * TILE_N
    _emit(metric="stage1_analysis_config", n_tiles=args.n_tiles, rows=n,
          int8_gb=db3.numel() / 1e9, b=B,
          device=torch.cuda.get_device_name(db3.device))
    _emit(metric="stage1_ideal", **ideal(n, B))
    # Production's K2 (the JAX probe's number) and K5 on the same codes:
    # K9's full is K2's instantiation with a step-major output.
    for metric, prod in (
            ("stage1_production_ms", lambda: fused_scan.segment_minima_tiled(
                db3, db_sq, penalty, q)),
            ("stage1_production_k5_ms", lambda: fused_scan
             .segment_minima_tiled2(db3, db_sq, penalty, q))):
        prod()                                             # warm-up
        prod_ms = _cuda_ms(prod, args.reps)
        _emit(metric=metric, value=prod_ms,
              gb_s=db3.numel() / 1e9 / (prod_ms / 1e3))
    return sweep(db3, db_sq, penalty, q, args.reps, variants)


if __name__ == "__main__":
    main()
