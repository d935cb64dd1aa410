"""
A numpy model of the shared-memory layout that the ``wgmma`` kernels of
K1 (``csrc/segment_minima_wgmma.cu``) and of K2 / K4 / K5
(``csrc/segment_minima_tiled_wgmma.cu``) stage and that their descriptors
ask the tensor cores to read (``csrc/wgmma.cuh``), for both operand
types: bf16 (k16 steps) and int8 (the s8 x s8 -> s32 form, k32 steps).
It checks, with no card:

- that the ``cp.async`` staging map (db rows, query rows) and the int8
  widening map are bijections onto their 128-byte-swizzle tiles;
- that every K step's descriptor (start address, LBO, SBO, layout type)
  reads back the (64 or 128) x 16 bf16 or x 32 int8 operand slice in
  wgmma's order, for the query tile (A) and the database tile (B), at d =
  128 and d = 1024 (and an int8 tail, d = 96), with the query tile
  resident or streamed through the ring;
- the shared-memory plan (which variant each d takes, tile alignment),
  the accumulator fragment the epilogue reduces, the exact int8 -> bf16
  widening and the s32 epilogue's order;
- for the tiled kernel, in both forms: the tiled addresses each thread
  loads (whole 32-byte sectors a warp), that the register transpose, the
  widening (bf16 only) and the swizzled store put code (row r, dim k)
  where the K-step descriptors read B[k][r], with the tail past d zero,
  that the stores are free of bank conflicts, that the strips, groups and
  step-major offsets write each output once, and its shared-memory plan.

The hardware's side of the model is the PTX ISA's K-major 128-byte swizzle
layout: an operand row r, byte kb of a K step (32 bytes: 16 bf16 or 32
int8 values) lies at the logical address ``start + (r // 8) * SBO + (r %
8) * 128 + kb`` (LBO unused), and the swizzle XORs address bits 4-6 with
bits 7-9. The kernel's side is read from the sources, so the model and the
kernel cannot drift apart.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CSRC =(Path(__file__).resolve().parent.parent / "smqtk_indexing_tpu_torch"
        / "csrc")


def _constants(name: str) -> dict:
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", text)}


H = _constants("wgmma.cuh")
#: The geometry both wgmma kernels share, then each kernel's own.
SHARED = _constants("wgmma_minima.cuh")
K = {**SHARED, **_constants("segment_minima_wgmma.cu")}
T = {**SHARED, **_constants("segment_minima_tiled_wgmma.cu")}
KERNEL_SRC = (CSRC / "segment_minima_wgmma.cu").read_text()
SHARED_SRC = (CSRC / "wgmma_minima.cuh").read_text()
LOADS_SRC = (CSRC / "scan_loads.cuh").read_text()
TILED_SRC = (CSRC / "segment_minima_tiled_wgmma.cu").read_text()

#: The PTX ISA's geometry of a K-major operand with 128-byte swizzle: rows
#: of 128 bytes, 8-row core groups, bf16 values, 16-byte pieces; a wgmma K
#: step reads 32 bytes of each row (k16 of bf16, k32 of s8).
HW_ROW_BYTES = 128
HW_CORE_ROWS = 8
HW_ELEM_BYTES = 2
HW_K_STEP_BYTES = 32
#: The two product forms: element bytes of the operands, their numpy
#: type, and the kernels' dims per K-chunk (read from the header).
FORMS = ("bf16", "s8")
ELEM = {"bf16": 2, "s8": 1}
NP_TYPE = {"bf16": np.uint16, "s8": np.int8}
CHUNK = {"bf16": SHARED["kChunkBf16"], "s8": SHARED["kChunkS8"]}


def swizzle_offset(row: int, piece: int) -> int:
    """``wgmma.cuh``'s swizzle_offset."""
    return (row * H["kSwizzleBytes"]
            + ((piece ^ (row % H["kAtomRows"])) * H["kPieceBytes"]))


def smem_desc(addr: int) -> int:
    """``wgmma.cuh``'s smem_desc."""
    return ((((addr & 0x3FFFF) >> 4) << H["kDescAddrShift"])
            | ((H["kLboBytes"] >> 4) << H["kDescLboShift"])
            | ((H["kSboBytes"] >> 4) << H["kDescSboShift"])
            | (H["kLayoutSwizzle128"] << H["kDescLayoutShift"]))


def hw_address(desc: int, row: int, kk: int, elem: int = HW_ELEM_BYTES
               ) -> int:
    """The shared byte address the tensor cores read for operand row
    ``row``, K offset ``kk`` (0 .. 32 / elem - 1) of the K step that
    ``desc`` describes (PTX ISA: matrix descriptor, K-major, 128-byte
    swizzle), for elements of ``elem`` bytes."""
    start = (desc & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    assert desc >> 62 == 1, "layout type must be the 128-byte swizzle"
    assert (desc >> 49) & 7 == 0, "base offset must be 0"
    assert 0 <= kk * elem < HW_K_STEP_BYTES
    logical = (start + (row // HW_CORE_ROWS) * sbo
               + (row % HW_CORE_ROWS) * HW_ROW_BYTES + kk * elem)
    return logical ^ (((logical >> 7) & 7) << 4)


def stage_rows(smem: np.ndarray, base: int, mat: np.ndarray,
               live: int = 8) -> None:
    """Write a (rows, chunk) K-chunk (uint16 bf16 patterns or int8; fewer
    columns than a chunk at a tail) into ``smem`` at ``base`` the way
    ``copy_chunk`` does: thread t copies pieces i = t + kThreads j, and
    pieces at or past ``live`` are zero-filled."""
    rows = mat.shape[0]
    raw = np.zeros((rows, H["kSwizzleBytes"]), np.uint8)
    data = np.ascontiguousarray(mat).view(np.uint8).reshape(rows, -1)
    raw[:, :data.shape[1]] = data
    for tid in range(K["kThreads"]):
        for j in range(rows * 8 // K["kThreads"]):
            i = tid + j * K["kThreads"]
            r, p = i >> 3, i & 7
            dst = base + swizzle_offset(r, p)
            smem[dst:dst + 16] = (raw[r, 16 * p:16 * p + 16] if p < live
                                  else 0)


def read_operand(smem: np.ndarray, desc: int, rows: int,
                 form: str = "bf16") -> np.ndarray:
    """The (rows, 32 / elem) slice the tensor cores read through desc."""
    elem = ELEM[form]
    width = HW_K_STEP_BYTES // elem
    out = np.empty((rows, width), NP_TYPE[form])
    for r in range(rows):
        for kk in range(width):
            a = hw_address(desc, r, kk, elem)
            out[r, kk] = smem[a:a + elem].view(NP_TYPE[form])[0]
    return out


def smem_plan(dim: int, form: str = "bf16"):
    """(m_tiles, stream_q, bytes) of the kernel's launch choice."""
    ring_db = K["kStages"] * K["kSeg"] * H["kSwizzleBytes"]
    n_chunks = -(-dim // CHUNK[form])
    for m_tiles, stream in ((2, False), (1, False), (2, True)):
        q_rows = 2 * K["kMTile"] * m_tiles
        q_chunk = q_rows * H["kSwizzleBytes"]
        total = H["kAtomBytes"] + ring_db + (
            K["kStages"] * q_chunk if stream
            else q_chunk * n_chunks)
        if total <= K["kMaxSmem"] or stream:
            return m_tiles, stream, total


def test_header_constants_match_the_hardware_geometry():
    assert H["kSwizzleBytes"] == HW_ROW_BYTES
    assert H["kAtomRows"] == HW_CORE_ROWS
    assert H["kAtomBytes"] == HW_CORE_ROWS * HW_ROW_BYTES
    assert H["kSboBytes"] == H["kAtomBytes"]   # row groups back to back
    assert H["kKStepBytes"] == HW_K_STEP_BYTES == 16 * HW_ELEM_BYTES
    assert H["kPieceBytes"] * 8 == H["kSwizzleBytes"]
    # A K-chunk is one swizzled row in both forms: four K steps.
    for form in FORMS:
        assert CHUNK[form] * ELEM[form] == H["kSwizzleBytes"]
    assert K["kChunkBf16"] == 64 and K["kChunkS8"] == 128
    assert K["kSeg"] == 128 and K["kMTile"] == 64  # m64n128k16
    assert K["kThreads"] == 256                     # two warpgroups


@pytest.mark.parametrize("addr", [0, 1024, 0x1F400, 0x38C00 + 96])
def test_descriptor_fields(addr):
    desc = smem_desc(addr)
    assert (desc & 0x3FFF) << 4 == addr & ~0xF
    assert ((desc >> 16) & 0x3FFF) << 4 == H["kLboBytes"]
    assert ((desc >> 32) & 0x3FFF) << 4 == H["kSboBytes"]
    assert desc >> 62 == 1 and (desc >> 49) & 7 == 0
    assert (desc >> 14) & 3 == 0 and (desc >> 30) & 3 == 0


@pytest.mark.parametrize("rows", [128, 256])
def test_cp_async_staging_is_a_bijection(rows):
    seen = np.zeros(rows * 8, np.int64)
    for tid in range(K["kThreads"]):
        for j in range(rows * 8 // K["kThreads"]):
            i = tid + j * K["kThreads"]
            off = swizzle_offset(i >> 3, i & 7)
            assert off % 16 == 0
            seen[off // 16] += 1
    assert (seen == 1).all()


def test_int8_widening_map_is_a_bijection():
    # store_regs: thread t widens codes [32 (t % 2), +32) of row t / 2
    # into logical pieces 4 (t % 2) + p, p < 4 (8 codes a piece).
    seen = np.zeros(K["kSeg"] * 8, np.int64)
    for tid in range(K["kThreads"]):
        r, half = tid >> 1, tid & 1
        for p in range(4):
            piece = 4 * half + p
            assert (32 * half + 8 * p) // 8 == piece   # codes stay in order
            seen[swizzle_offset(r, piece) // 16] += 1
    assert (seen == 1).all()


def _check_k1_descriptors(form: str, dim: int, operand: str, stream: bool):
    """Stage every K-chunk of a random (rows, dim) operand as K1 does and
    read each K step back through its descriptor: the operand's slice of
    32 bytes a row, zeros past d."""
    m_tiles, stream_plan, total = smem_plan(dim, form)
    assert stream_plan == stream
    rng = np.random.default_rng(dim)
    q_rows = 2 * K["kMTile"] * m_tiles
    rows = q_rows if operand == "A" else K["kSeg"]
    if form == "bf16":
        mat = rng.integers(0, 1 << 16, size=(rows, dim)).astype(np.uint16)
    else:
        mat = rng.integers(-128, 128, size=(rows, dim)).astype(np.int8)
    chunk, piece = CHUNK[form], H["kPieceBytes"] // ELEM[form]
    width = HW_K_STEP_BYTES // ELEM[form]
    padded = np.zeros((rows, -(-dim // chunk) * chunk), mat.dtype)
    padded[:, :dim] = mat
    # The kernel's ring starts on the first 1024-byte boundary of dynamic
    # shared memory, which need not be aligned itself.
    raw = 48
    ring = (raw + H["kAtomBytes"] - 1) & ~(H["kAtomBytes"] - 1)
    db_stage = K["kSeg"] * H["kSwizzleBytes"]
    stage_bytes = db_stage + (q_rows * H["kSwizzleBytes"] if stream else 0)
    q_res = ring + K["kStages"] * stage_bytes
    smem = np.full(ring + total, 0xAB, np.uint8)
    for c in range(-(-dim // chunk)):
        stage = ring + (c % K["kStages"]) * stage_bytes
        if operand == "B":
            tile = stage
        elif stream:
            tile = stage + db_stage
        else:
            tile = q_res + c * q_rows * H["kSwizzleBytes"]
        assert tile % H["kAtomBytes"] == 0
        # live_pieces(c): whole pieces of the chunk before d.
        live = min(8, (dim - c * chunk) // piece)
        stage_rows(smem, tile, np.ascontiguousarray(
            mat[:, c * chunk:(c + 1) * chunk]), live)
        for k in range(H["kSwizzleBytes"] // H["kKStepBytes"]):
            cols = slice(c * chunk + width * k, c * chunk + width * (k + 1))
            if operand == "B":
                desc = smem_desc(tile + k * H["kKStepBytes"])
                assert np.array_equal(read_operand(smem, desc, rows, form),
                                      padded[:, cols])
                continue
            for wg in range(2):
                for i in range(m_tiles):
                    m0 = (wg * m_tiles + i) * K["kMTile"]
                    desc = smem_desc(tile + m0 * H["kSwizzleBytes"]
                                     + k * H["kKStepBytes"])
                    got = read_operand(smem, desc, K["kMTile"], form)
                    assert np.array_equal(got, padded[m0:m0 + 64, cols])


@pytest.mark.parametrize("dim,operand,stream", [
    (128, "A", False), (128, "B", False),
    (1024, "A", True), (1024, "B", True), (512, "A", False)])
def test_each_k16_descriptor_reads_its_operand_slice(dim, operand, stream):
    _check_k1_descriptors("bf16", dim, operand, stream)


@pytest.mark.parametrize("dim,operand,stream", [
    (128, "A", False), (128, "B", False), (96, "A", False),
    (96, "B", False), (32, "B", False), (1024, "A", False),
    (1024, "B", False), (2048, "A", True), (2048, "B", True)])
def test_each_k32_descriptor_reads_its_s8_operand_slice(dim, operand,
                                                        stream):
    # K1's int8 x int8 form: 128 int8 dims a K-chunk, k32 steps, the tail
    # past d (d = 96, 32) zero in the staged tile.
    _check_k1_descriptors("s8", dim, operand, stream)


@pytest.mark.parametrize("dim", [128, 256, 384, 640, 768, 1024, 4096])
def test_shared_memory_plan_fits(dim):
    m_tiles, stream, total = smem_plan(dim)
    assert total <= K["kMaxSmem"]
    assert stream == (dim > 640)
    assert m_tiles == (1 if 256 < dim <= 640 else 2)


@pytest.mark.parametrize("dim", [32, 96, 128, 512, 640, 768, 1024, 1280,
                                 1408, 4096])
def test_s8_shared_memory_plan_fits(dim):
    # 128 int8 dims a K-chunk: 256 resident queries to d = 640, 128 to
    # d = 1280, streamed above; the kernel's launch makes the same choice.
    m_tiles, stream, total = smem_plan(dim, "s8")
    assert total <= K["kMaxSmem"]
    assert stream == (dim > 1280)
    assert m_tiles == (1 if 640 < dim <= 1280 else 2)
    assert "const int64_t n_chunks = (dim + chunk_dims<Q>() - 1) / " \
        "chunk_dims<Q>();" in KERNEL_SRC
    assert "if (smem_bytes<Q, T, 2, false, kPasses>(dim) <= kMaxSmem) {" \
        in KERNEL_SRC
    assert "const int64_t unit = sizeof(Q) == 1 ? 32 : 2 * kChunkBf16;" \
        in KERNEL_SRC


# -- K1's f32 forms: split3 and native (f32 rows split in registers) ------

#: The f32 forms: bf16 tiles a K-chunk of each operand (hi, lo) and the
#: products a K step, as (query part, database part): q hi x db hi, then
#: split3's q hi x db lo and q lo x db hi.
F32_PARTS = {"split3": 2, "native": 1}
F32_PASSES = {"split3": ((0, 0), (0, 1), (1, 0)), "native": ((0, 0),)}


def f32_smem_plan(dim: int, form: str):
    """(m_tiles, stream_q, bytes) of the f32 forms' launch choice: a ring
    of kRegStages stages, each the database's parts (16 KB each) and,
    streamed, the query's; the resident query's parts otherwise."""
    parts = F32_PARTS[form]
    db_stage = K["kSeg"] * H["kSwizzleBytes"]
    n_chunks = -(-dim // K["kChunkBf16"])
    for m_tiles, stream in ((2, False), (1, False), (2, True)):
        q_chunk = 2 * K["kMTile"] * m_tiles * H["kSwizzleBytes"]
        stage = parts * (db_stage + (q_chunk if stream else 0))
        total = H["kAtomBytes"] + K["kRegStages"] * stage + (
            0 if stream else parts * q_chunk * n_chunks)
        if total <= K["kMaxSmem"] or stream:
            return m_tiles, stream, total


#: Each f32 form's plan by d: (resident 256 up to, resident 128 up to).
F32_PLANS = {"split3": (128, 256), "native": (384, 768)}


@pytest.mark.parametrize("dim", [128, 256, 384, 512, 768, 896, 1024, 4096])
@pytest.mark.parametrize("form", list(F32_PARTS))
def test_f32_shared_memory_plan_fits(form, dim):
    # Two ring stages (the f32 forms stage the database through registers,
    # one step ahead); every plan fits in a block's shared memory, and the
    # streamed plan does at any d.
    m_tiles, stream, total = f32_smem_plan(dim, form)
    assert total <= K["kMaxSmem"]
    wide, narrow = F32_PLANS[form]
    assert stream == (dim > narrow)
    assert m_tiles == (1 if wide < dim <= narrow else 2)
    if form == "split3" and dim == 128:
        assert total == 197632          # 193 KB: 256 resident queries
    # The kernel's side: its ring, parts and byte counts.
    assert K["kRegStages"] == 2
    for line in (
            "return std::is_same<T, float>::value ? kRegStages : kStages;",
            "return kPasses == 3 ? 2 : 1;",
            "return parts<kPasses>() *\n"
            "         (kDbStageBytes + (kStreamQ ? q_rows<kMTiles>() * "
            "kSwizzleBytes : 0));",
            ": parts<kPasses>() * q_rows<kMTiles>() *\n"
            "                                       n_chunks * kSwizzleBytes;",
            "ring_stages<T>() * stage_bytes<kMTiles, kStreamQ, kPasses>() "
            "+ q_res;",
            "if (smem > kMaxSmem) return static_cast<int>("
            "cudaErrorInvalidValue);"):
        assert line in KERNEL_SRC, line


def _split_parts(x: np.ndarray):
    """``scan_loads.cuh``'s split_bf16x2 on f32 values, as bit patterns:
    hi = bf16_rn(x), lo = bf16_rn(x - f32(hi)), rounded to nearest even
    (the PTX ISA's cvt.rn.bf16x2.f32)."""
    def rn(v):
        u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
        return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    hi = rn(x)
    back = (hi.astype(np.uint32) << 16).view(np.float32)
    return hi, rn(np.asarray(x, np.float32) - back)


def test_split_matches_torch_rounding_bit_for_bit():
    # The model of the kernel's split is the wrapper's (torch .to(bf16)),
    # bit for bit, over magnitudes from the subnormal range up, ties to
    # even included; and the source packs x0 in the low half.
    from smqtk_indexing_tpu_torch.ops.fused_scan import split_bf16
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000)
         * np.exp2(rng.integers(-140, 60, 20000))).astype(np.float32)
    ties = (np.arange(1, 200, dtype=np.uint32) << 16) | 0x8000
    x = np.concatenate([x, ties.view(np.float32), -ties.view(np.float32),
                        np.float32([0.0, -0.0, 1e-45, 218.0])])
    hi, lo = _split_parts(x)
    th, tl = split_bf16(torch.from_numpy(x))
    assert np.array_equal(hi, th.view(torch.int16).numpy().view(np.uint16))
    assert np.array_equal(lo, tl.view(torch.int16).numpy().view(np.uint16))
    fn = LOADS_SRC[LOADS_SRC.index("void split_bf16x2("):]
    fn = fn[:fn.index("\n}")]
    assert "hi = bf16x2_rn(x0, x1);" in fn
    assert "lo = bf16x2_rn(x0 - __uint_as_float(hi << 16),\n" \
        "                 x1 - __uint_as_float(hi & 0xffff0000u));" in fn
    assert 'asm("cvt.rn.bf16x2.f32 %0, %1, %2;\\n" : "=r"(d) : "f"(x1), ' \
        '"f"(x0));' in LOADS_SRC


def test_split_staging_is_a_bijection_onto_hi_and_lo():
    # store_regs: thread t splits values [32 (t % 2), +32) of row t / 2
    # of the f32 K-chunk into logical pieces 4 (t % 2) + p of the hi tile
    # and, at the same offset kDbStageBytes on, the lo tile.
    db_stage = K["kSeg"] * H["kSwizzleBytes"]
    seen = np.zeros(2 * db_stage // 16, np.int64)
    for tid in range(K["kThreads"]):
        r, half = tid >> 1, tid & 1
        for p in range(4):
            off = swizzle_offset(r, 4 * half + p)
            for part in range(2):
                seen[(part * db_stage + off) // 16] += 1
    assert (seen == 1).all()
    for line in ("db_row(t)(tid >> 1) + (tid & 1) * 32);",
                 "constexpr int kWords = 32 * static_cast<int>(sizeof(T)) "
                 "/ 16;",
                 "const uint32_t off = swizzle_offset(r, (tid & 1) * 4 + p);",
                 "*reinterpret_cast<uint4*>(stage + kDbStageBytes + off) "
                 "= lo;",
                 "split_bf16x2(a.x, a.y, hi.x, lo.x);",
                 "split_bf16x2(b.z, b.w, hi.w, lo.w);"):
        assert line in KERNEL_SRC, line


def _check_f32_forms(form: str, dim: int):
    """Stage a random f32 database chunk by chunk as the f32 forms do
    (hi and lo tiles through registers, the query's hi and lo parts by
    cp.async, resident or streamed) and read every K step of every pass
    back through its descriptors; the passes' products summed over the
    K steps are qh.xh (+ qh.xl + ql.xh) in float64."""
    m_tiles, stream, total = f32_smem_plan(dim, form)
    parts, ring_n = F32_PARTS[form], K["kRegStages"]
    rng = np.random.default_rng(dim + parts)
    q_rows, seg = 2 * K["kMTile"] * m_tiles, K["kSeg"]
    x = (rng.random((seg, dim)) * 218.0).astype(np.float32)
    qf = (rng.random((q_rows, dim)) * 218.0).astype(np.float32)
    xs, qs = _split_parts(x), _split_parts(qf)
    chunk, q_chunk = K["kChunkBf16"], q_rows * H["kSwizzleBytes"]
    db_stage = seg * H["kSwizzleBytes"]
    raw = 48
    ring = (raw + H["kAtomBytes"] - 1) & ~(H["kAtomBytes"] - 1)
    stage_bytes = parts * (db_stage + (q_chunk if stream else 0))
    q_res = ring + ring_n * stage_bytes
    smem = np.full(ring + total, 0xAB, np.uint8)
    f64 = {s: (v.astype(np.uint32) << 16).view(np.float32).astype(np.float64)
           for s, v in (("xh", xs[0]), ("xl", xs[1]), ("qh", qs[0]),
                        ("ql", qs[1]))}
    want = f64["qh"] @ f64["xh"].T
    if parts == 2:
        want += f64["qh"] @ f64["xl"].T + f64["ql"] @ f64["xh"].T
    got = np.zeros((q_rows, seg))
    for c in range(-(-dim // chunk)):
        stage = ring + (c % ring_n) * stage_bytes
        cols = slice(c * chunk, (c + 1) * chunk)

        def q_tile(s):
            return (stage + parts * db_stage + s * q_chunk if stream
                    else q_res + (c * parts + s) * q_chunk)
        for tid in range(K["kThreads"]):
            r, half = tid >> 1, tid & 1
            for p in range(4):
                off = swizzle_offset(r, 4 * half + p)
                lo_col = c * chunk + 32 * half + 8 * p
                for s in range(parts):
                    piece = xs[s][r, lo_col:lo_col + 8]
                    base = stage + s * db_stage + off
                    smem[base:base + 16] = piece.view(np.uint8)
        for s in range(parts):
            assert q_tile(s) % H["kAtomBytes"] == 0
            stage_rows(smem, q_tile(s), np.ascontiguousarray(qs[s][:, cols]))
        for k in range(H["kSwizzleBytes"] // H["kKStepBytes"]):
            kc = slice(c * chunk + 16 * k, c * chunk + 16 * (k + 1))
            for qp, dp in F32_PASSES[form]:
                b = read_operand(smem, smem_desc(
                    stage + dp * db_stage + k * H["kKStepBytes"]), seg)
                assert np.array_equal(b, xs[dp][:, kc])
                for m0 in range(0, q_rows, K["kMTile"]):
                    a = read_operand(smem, smem_desc(
                        q_tile(qp) + m0 * H["kSwizzleBytes"]
                        + k * H["kKStepBytes"]), K["kMTile"])
                    assert np.array_equal(a, qs[qp][m0:m0 + 64, kc])
                    af = (a.astype(np.uint32) << 16).view(np.float32)
                    bf = (b.astype(np.uint32) << 16).view(np.float32)
                    got[m0:m0 + 64] += af.astype(np.float64) \
                        @ bf.astype(np.float64).T
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("form,dim", [
    ("split3", 128), ("split3", 256), ("split3", 384), ("native", 128),
    ("native", 512), ("native", 1024)])
def test_f32_forms_feed_each_k16_descriptor_its_parts(form, dim):
    # d = 128: 256 resident queries; split3 at 256 / native at 512: 128
    # resident; split3 at 384 / native at 1024: the query streamed.
    _check_f32_forms(form, dim)
    for line in (
            "return kStreamQ ? stage + kParts * kDbStageBytes + s * "
            "kQChunkBytes\n                    : q_res + (c * kParts + s) * "
            "kQChunkBytes;",
            "stage + (pass == 1 ? kDbStageBytes : 0) + k * kKStepBytes);",
            "const uint32_t a_tile = q_tile(stage, c, pass == 2 ? 1 : 0) "
            "+ a_off;",
            "wgmma_step(acc[i], a_desc, b_desc, (c | k | pass) != 0);",
            "return q + (s * n_queries + qr) * dim + c * kDims;"):
        assert line in KERNEL_SRC, line
    for entry, args in (("segment_minima_f32_split3", "<uint16_t, float, 3>"),
                        ("segment_minima_f32_native", "<uint16_t, float, 1>")):
        body = KERNEL_SRC[KERNEL_SRC.index(f'extern "C" int {entry}('):]
        assert f"return launch{args}(" in body[:body.index("\n}")]


def test_accumulator_fragment_and_quad_reduction():
    # d[4 j + 2 h + e] of lane l in warp w: row 16 w + l / 4 + 8 h, column
    # 8 j + 2 (l % 4) + e. Each (row, column) once, and the 4 lanes of a
    # quad hold every column of their two rows.
    owner = -np.ones((64, 128), np.int64)
    for t in range(128):
        w, lane = t // 32, t % 32
        for i in range(64):
            j, h, e = i // 4, (i // 2) % 2, i % 2
            row = 16 * w + lane // 4 + 8 * h
            col = 8 * j + 2 * (lane % 4) + e
            assert owner[row, col] == -1
            owner[row, col] = t
    assert (owner >= 0).all()
    for row in range(64):
        lanes = set(owner[row] % 32)
        quads = {lane // 4 for lane in lanes}
        assert len(lanes) == 4 and len(quads) == 1   # xor 1 and 2 suffice
    assert "__shfl_xor_sync(0xffffffffu, v, 1)" in SHARED_SRC
    assert "__shfl_xor_sync(0xffffffffu, v, 2)" in SHARED_SRC
    for src in (KERNEL_SRC, TILED_SRC):
        assert "quad_min(m[i][h])" in src and "fold_minima<kMTiles" in src


WGMMA_SRC = (CSRC / "wgmma.cuh").read_text()


def test_s8_product_and_epilogue():
    # The integer wgmma takes only the scale-d predicate after the
    # descriptors (no scale or transpose immediates) and s32 registers;
    # its accumulator fragment is the f32 one's (PTX ISA, wgmma D
    # fragments: the same for every K of m64nNk*), so the fold and quad
    # reduction above serve both forms.
    body = WGMMA_SRC[WGMMA_SRC.index("void wgmma_m64n128k32_s8("):]
    body = body[:body.index("\n}")]
    assert "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " in body
    assert 'WGMMA_D64_REGS ", %64, %65, p;\\n"' in body
    assert 'WGMMA_D64("+r", d)' in body
    assert 'asm volatile("" : "+r"(r)::"memory");' in WGMMA_SRC
    regs = re.findall(r"%(\d+)", WGMMA_SRC[
        WGMMA_SRC.index("#define WGMMA_D64_REGS"):
        WGMMA_SRC.index("#define WGMMA_D64(C, d)")])
    assert [int(r) for r in regs] == list(range(64))
    assert len(re.findall(r"C\(d\[\d+\]\)", WGMMA_SRC)) == 64
    # The epilogue: ip = float(acc) * scale, then (db_sq - 2 ip) + penalty;
    # K1 passes scale 1, the tiled kernel its argument.
    assert "const float ip0 = inner(acc[i][4 * j + 2 * h], scale);" \
        in SHARED_SRC
    assert "m[i][h] = fminf(m[i][h], score(sp.x, ip0, sp.z));" \
        in SHARED_SRC
    assert "float v = sq - 2.0f * ip;\n    if constexpr (kPen) v = v + pen;" \
        in SHARED_SRC
    assert "fold_minima<kMTiles>(acc, 1.0f, [&](int j) {" in KERNEL_SRC
    assert "return static_cast<float>(acc) * scale;" in LOADS_SRC
    # float(acc) is exact: at d = 1024 the largest |<q, x>| of int8 codes
    # and a query in [-127, 127] is below 2^24, and every integer there is
    # an f32.
    top = 1024 * 128 * 127
    assert top < 2 ** 24
    acc = np.random.default_rng(0).integers(-top, top + 1, 100000)
    assert (acc.astype(np.float32).astype(np.int64) == acc).all()
    # Each K1 entry point instantiates its form: <query, database>.
    for entry, form in (("segment_minima_bf16", "<uint16_t, uint16_t>"),
                        ("segment_minima_i8", "<uint16_t, int8_t>"),
                        ("segment_minima_i8i8", "<int8_t, int8_t>")):
        body = KERNEL_SRC[KERNEL_SRC.index(f'extern "C" int {entry}('):]
        assert f"return launch{form}(" in body[:body.index("\n}")]


def _byte_perm(x: int, y: int, s: int) -> int:
    b = x | (y << 32)
    out = 0
    for i in range(4):
        sel = (s >> (4 * i)) & 0xF
        assert sel < 8       # no sign-replicate mode
        out |= ((b >> (8 * sel)) & 0xFF) << (8 * i)
    return out


def _widen_fn():
    """``scan_loads.cuh``'s codes_to_bf16x2, read from the source: (w, k)
    -> the bf16x2 word of bytes k and k + 1 of w (already XORed with
    0x80)."""
    fn = LOADS_SRC[LOADS_SRC.index("codes_to_bf16x2(uint32_t w"):]
    fn = fn[:fn.index("\n}")]
    magic = int(re.search(r"0x([0-9A-F]{8})u", fn).group(1), 16)
    offset = float(re.search(r"([0-9.]+)f;", fn).group(1))
    sel = int(re.search(r"0x(75\d0) \| k\)", fn).group(1), 16)
    pack = int(re.search(r"0x(7632)\)", fn).group(1), 16)

    def widen(w: int, k: int) -> int:
        fl = np.array([_byte_perm(w, magic, sel | (k + i)) for i in (0, 1)],
                      np.uint32).view(np.float32) - np.float32(offset)
        return _byte_perm(int(fl.view(np.uint32)[0]),
                          int(fl.view(np.uint32)[1]), pack)
    return widen


def test_int8_codes_widen_exactly_to_bf16():
    widen = _widen_fn()
    for src in (KERNEL_SRC, TILED_SRC):
        assert "0x80808080u" in src
    codes = np.arange(-128, 128, dtype=np.int64)
    want = _bf16_bits(codes)
    for lo in range(0, 256, 2):
        w = ((int(codes[lo]) & 0xFF) | ((int(codes[lo + 1]) & 0xFF) << 8)) \
            ^ 0x8080
        word = widen(w, 0)
        assert word & 0xFFFF == want[lo]
        assert word >> 16 == want[lo + 1]
        assert widen(w << 16, 2) == word


def _bf16_bits(codes: np.ndarray) -> np.ndarray:
    """The bf16 bit patterns of integer codes."""
    return torch.from_numpy(np.asarray(codes, np.float32)) \
        .to(torch.bfloat16).view(torch.int16).numpy().astype(np.uint16)


# -- the tiled layout's kernel (segment_minima_tiled_wgmma.cu) -------------

#: The thread map, the load addresses, the strip and the output offsets
#: as the kernel writes them; the model below restates each.
TILED_LINES = (
    "const int o = (lane % kDimGroups) + kDimGroups * ((tid >> 5) & 1);",
    "const int p = (lane / kDimGroups) + kRowQuads * (tid >> 6);",
    "int64_t ld_col = seg0 % nseg_t;",
    "const int8_t* ld_src = db3 + (seg0 / nseg_t) * dim * tile_n +\n"
    "                         ld_col * kSeg + 4 * p;",
    "uint32_t words[kPiece];",
    "const int64_t k0 = ld_c * kDims + kPiece * o;",
    "const bool live = k0 < dim;",
    "for (int i = 0; i < kPiece; ++i) {",
    "ld_src + (k0 + i) * tile_n",
    "if (++ld_c == n_chunks) {",
    "if (++ld_col == nseg_t) {",
    "ld_src += dim * tile_n - (nseg_t - 1) * kSeg;",
    "ld_src += kSeg;",
    "const uint32_t flip = kWiden ? 0x80808080u : 0u;",
    "const uint32_t w[4] = {words[4 * u] ^ flip, words[4 * u + 1] ^ flip,\n"
    "                             words[4 * u + 2] ^ flip,\n"
    "                             words[4 * u + 3] ^ flip};",
    "transpose4x4(w, rows[u]);",
    "v.x = codes_to_bf16x2(rows[0][j], 0);",
    "v.y = codes_to_bf16x2(rows[0][j], 2);",
    "v.z = codes_to_bf16x2(rows[1][j], 0);",
    "v.w = codes_to_bf16x2(rows[1][j], 2);",
    "v = make_uint4(rows[0][j], rows[1][j], rows[2][j], rows[3][j]);",
    "stage + swizzle_offset(4 * p + j, o)",
    "const uint64_t b_desc = smem_desc(stage + k * kKStepBytes);",
    "wgmma_step(acc[i], a_desc, b_desc, (c | k) != 0);",
    "return bw >= kStrip ? bw : bw * (kStrip / bw);",
    "int64_t step = seg0 / g, gi = seg0 % g, gq = gi / bw, gpos = 0;",
    "const bool group_end = out2 != nullptr && ++gpos == bw;",
    "out1[(step * n_queries + qi) * g + gi] = v;",
    "out2[(step * n_queries + qi) * (g / bw) + gq] = gmin[i][h];",
    "if (group_end) {\n      gpos = 0;\n      ++gq;\n    }",
    "if (++gi == g) {  // the next step of the output\n      gi = 0;\n"
    "      gq = 0;\n      ++step;\n    }",
    "cp_async16(stats + (j & 1) * kStatsSlotBytes + 16 * tid, src);",
    "const float* src = (tid < 32 ? db_sq : penalty) + (seg0 + j) * kSeg +\n"
    "                         4 * (tid & 31);",
    "const int64_t qr = q0 + r < n_queries ? q0 + r : n_queries - 1;",
    "const int64_t left = (dim - c * kDims) / kPiece;",
    "constexpr bool kWiden = sizeof(Q) == 2;",
    "constexpr int kDims = chunk_dims<Q>();",
    "constexpr int kPiece = piece_dims<Q>();",
    "fold_minima<kMTiles, V != kFolded, V == kBf16Min>(\n"
    "          acc, scale, [&](int jj) {",
)
#: The query type of each form, as the tiled kernel's entry points
#: instantiate it.
TILED_Q = {"bf16": "uint16_t", "s8": "int8_t"}


def test_tiled_kernel_source_matches_the_model():
    for line in TILED_LINES:
        assert line in TILED_SRC, line
    assert T["kThreads"] == 256 and T["kSeg"] == 128
    # A thread covers one piece (P dims) x 4 rows; the block covers one
    # K-chunk of 128 rows in both forms.
    for form in FORMS:
        piece = H["kPieceBytes"] // ELEM[form]
        assert piece * 4 * T["kThreads"] == CHUNK[form] * T["kSeg"]
        assert 2 * T["kDimGroups"] * piece == CHUNK[form]
    assert T["kRowQuads"] * T["kDimGroups"] == 32
    assert 4 * T["kRowQuads"] * 4 == T["kSeg"]
    for entry, form in (("segment_minima_tiled_i8(", "bf16"),
                        ("segment_minima_tiled2_i8(", "bf16"),
                        ("segment_minima_tiled_i8i8(", "s8"),
                        ("segment_minima_tiled2_i8i8(", "s8")):
        body = TILED_SRC[TILED_SRC.index(f'extern "C" int {entry}'):]
        body = body[:body.index("\n}")]
        assert f"return launch<{TILED_Q[form]}>(" in body, entry


def tiled_thread(tid: int):
    """(dim group o, row quad p) of thread tid."""
    lane = tid & 31
    o = lane % T["kDimGroups"] + T["kDimGroups"] * ((tid >> 5) & 1)
    p = lane // T["kDimGroups"] + T["kRowQuads"] * (tid >> 6)
    return o, p


def piece_dims(form: str) -> int:
    """Dims of one 16-byte piece: the words a thread loads a step."""
    return H["kPieceBytes"] // ELEM[form]


def tiled_loads(seg: int, c: int, tid: int, dim: int, tile_n: int,
                form: str = "bf16"):
    """The flat db3 offsets of thread tid's words for K-chunk c of segment
    seg, and whether they are live (else zeros)."""
    o, p = tiled_thread(tid)
    nseg_t = tile_n // T["kSeg"]
    piece = piece_dims(form)
    k0 = c * CHUNK[form] + piece * o
    src = (seg // nseg_t) * dim * tile_n + (seg % nseg_t) * T["kSeg"] + 4 * p
    return [src + (k0 + i) * tile_n for i in range(piece)], k0 < dim


def walk_loads(seg0: int, n_steps: int, tid: int, dim: int, tile_n: int,
               form: str = "bf16"):
    """load_codes called once a step from the strip's first segment, with
    its running pointer: the offsets and liveness of each step."""
    o, p = tiled_thread(tid)
    nseg_t = tile_n // T["kSeg"]
    n_chunks = -(-dim // CHUNK[form])
    piece = piece_dims(form)
    ld_c, ld_col = 0, seg0 % nseg_t
    ld_src = (seg0 // nseg_t) * dim * tile_n + ld_col * T["kSeg"] + 4 * p
    out = []
    for _ in range(n_steps):
        k0 = ld_c * CHUNK[form] + piece * o
        out.append(([ld_src + (k0 + i) * tile_n for i in range(piece)],
                    k0 < dim))
        ld_c += 1
        if ld_c == n_chunks:
            ld_c = 0
            ld_col += 1
            if ld_col == nseg_t:
                ld_col = 0
                ld_src += dim * tile_n - (nseg_t - 1) * T["kSeg"]
            else:
                ld_src += T["kSeg"]
    return out


@pytest.mark.parametrize("dim", [48, 144])
@pytest.mark.parametrize("tile_n", list(TILED_SHAPES_ALL := (128, 4096)))
def test_tiled_running_load_pointer_walks_the_strip(tile_n, dim):
    # A strip that starts mid-tile and crosses tile ends: each step's
    # loads are those of its (segment, K-chunk), in both forms (the s8
    # form at d + 16, a multiple of 32 with a tail in its last chunk).
    nseg_t = tile_n // T["kSeg"]
    seg0 = nseg_t + nseg_t // 2
    for form, d in (("bf16", dim), ("s8", dim + 16)):
        n_chunks = -(-d // CHUNK[form])
        n_steps = (2 * nseg_t + 3) * n_chunks
        for tid in (0, 37, 255):
            for t, got in enumerate(walk_loads(seg0, n_steps, tid, d, tile_n,
                                               form)):
                assert got == tiled_loads(seg0 + t // n_chunks,
                                          t % n_chunks, tid, d, tile_n, form)


def _transpose_fn():
    """``scan_loads.cuh``'s transpose4x4, run from its __byte_perm lines."""
    fn = LOADS_SRC[LOADS_SRC.index("void transpose4x4("):]
    fn = fn[:fn.index("\n}")]
    stmts = re.findall(r"(?:const uint32_t )?(\w+(?:\[\d\])?) = __byte_perm"
                       r"\((\w+(?:\[\d\])?), (\w+(?:\[\d\])?), "
                       r"0x([0-9A-Fa-f]+)\);", fn)
    assert len(stmts) == 8

    def transpose(w):
        env = {f"w[{i}]": int(w[i]) for i in range(4)}
        for dst, x, y, sel in stmts:
            env[dst] = _byte_perm(env[x], env[y], int(sel, 16))
        return [env[f"o[{j}]"] for j in range(4)]
    return transpose


def hw_addresses(desc: int, rows: int, elem: int = HW_ELEM_BYTES
                 ) -> np.ndarray:
    """:func:`hw_address` for every (row, kk) of a K step: (rows, 32 /
    elem)."""
    r = np.arange(rows)[:, None]
    kk = np.arange(HW_K_STEP_BYTES // elem)[None, :]
    start = (desc & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    assert desc >> 62 == 1 and (desc >> 49) & 7 == 0
    logical = (start + (r // HW_CORE_ROWS) * sbo
               + (r % HW_CORE_ROWS) * HW_ROW_BYTES + kk * elem)
    return logical ^ (((logical >> 7) & 7) << 4)


#: Bytes of one staged K-chunk of codes: 128 rows of 128 bytes (64 bf16
#: or 128 int8 dims).
TILED_STAGE = T["kSeg"] * H["kSwizzleBytes"]

#: (tile_n, n_tiles) of the tiled cases: one and several segments a tile.
TILED_SHAPES = {128: 5, 4096: 3}
TILED_DIMS = [16, 48, 128, 144]
#: The s8 form's widths: multiples of 32 (the wrapper's rule), with a
#: K-chunk tail (32, 96, 160) and whole chunks (128).
TILED_DIMS_S8 = [32, 96, 128, 160]


def _tiled_case(tile_n: int, where: str, dim: int):
    """(db3 codes (n_tiles, dim, tile_n) int8, segment)."""
    n_tiles = TILED_SHAPES[tile_n]
    rng = np.random.default_rng(tile_n + dim)
    db3 = rng.integers(-128, 128, size=(n_tiles, dim, tile_n)).astype(np.int8)
    db3[0, 0, :4] = (-128, 127, 0, -1)
    n_seg = n_tiles * tile_n // T["kSeg"]
    seg = {"first": 0, "middle": n_seg // 2 + 1, "last": n_seg - 1}[where]
    return db3, seg


def _check_tiled_loads(tile_n: int, where: str, dim: int, form: str):
    db3, seg = _tiled_case(tile_n, where, dim)
    n_tiles = db3.shape[0]
    nseg_t = tile_n // T["kSeg"]
    chunk, piece = CHUNK[form], piece_dims(form)
    for c in range(-(-dim // chunk)):
        seen = np.zeros((T["kSeg"], chunk), np.int64)
        for tid in range(T["kThreads"]):
            o, p = tiled_thread(tid)
            offs, live = tiled_loads(seg, c, tid, dim, tile_n, form)
            if not live:
                continue
            for i, off in enumerate(offs):
                assert off % 4 == 0 and 0 <= off <= db3.size - 4
                t, k, col = np.unravel_index(off, db3.shape)
                # One word: rows 4 p .. 4 p + 3 of the segment, dim i of
                # the thread's group.
                assert t == seg // nseg_t and k == c * chunk + piece * o + i
                assert col == (seg % nseg_t) * T["kSeg"] + 4 * p
                seen[4 * p:4 * p + 4, piece * o + i] += 1
        live_dims = min(chunk, dim - c * chunk)
        assert (seen[:, :live_dims] == 1).all()
        assert (seen[:, live_dims:] == 0).all()
        assert n_tiles * nseg_t > seg
    # Each warp's load of word i reads whole 32-byte sectors: 4 dims x 32
    # contiguous bytes.
    for w in range(T["kThreads"] // 32):
        for i in range(piece):
            addrs = [tiled_loads(seg, 0, 32 * w + lane, 4096, 4096, form)[0][i]
                     for lane in range(32)]
            sectors = {a // 32 for a in addrs}
            assert len(sectors) == 4
            assert sorted(addrs) == sorted(
                s * 32 + b for s in sectors for b in range(0, 32, 4))


@pytest.mark.parametrize("dim", TILED_DIMS)
@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("tile_n", list(TILED_SHAPES))
def test_tiled_loads_cover_each_code_of_a_chunk_once(tile_n, where, dim):
    _check_tiled_loads(tile_n, where, dim, "bf16")


@pytest.mark.parametrize("dim", TILED_DIMS_S8)
@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("tile_n", list(TILED_SHAPES))
def test_tiled_s8_loads_cover_each_code_of_a_chunk_once(tile_n, where, dim):
    _check_tiled_loads(tile_n, where, dim, "s8")


def _check_tiled_staging(tile_n: int, where: str, dim: int, form: str):
    """Run every thread's loads, transposes, widening (bf16) and swizzled
    stores of each K-chunk of a segment, then read each K step back
    through its descriptor: B[k][r] in the form's type, zeros past d."""
    db3, seg = _tiled_case(tile_n, where, dim)
    flat = db3.view(np.uint8).reshape(-1)
    transpose, widen = _transpose_fn(), _widen_fn()
    rows = seg * T["kSeg"] + np.arange(T["kSeg"])
    # Code (row r of the segment, dim k) in row order.
    seg_codes = db3[rows // tile_n, :, rows % tile_n]          # (128, dim)
    chunk, piece, elem = CHUNK[form], piece_dims(form), ELEM[form]
    width = HW_K_STEP_BYTES // elem
    flip = 0x80808080 if form == "bf16" else 0
    stage = 3 * H["kAtomBytes"]        # any 1024-byte-aligned stage
    for c in range(-(-dim // chunk)):
        smem = np.full(stage + TILED_STAGE, 0xAB, np.uint8)
        writes = np.zeros(TILED_STAGE // 16, np.int64)
        for tid in range(T["kThreads"]):
            o, p = tiled_thread(tid)
            offs, live = tiled_loads(seg, c, tid, dim, tile_n, form)
            words = [int.from_bytes(flat[a:a + 4].tobytes(), "little")
                     if live else 0 for a in offs]
            rows_u = [transpose([w ^ flip for w in words[4 * u:4 * u + 4]])
                      for u in range(piece // 4)]
            for j in range(4):
                if form == "bf16":
                    v = np.array([widen(rows_u[0][j], 0),
                                  widen(rows_u[0][j], 2),
                                  widen(rows_u[1][j], 0),
                                  widen(rows_u[1][j], 2)], np.uint32)
                else:
                    v = np.array([rows_u[u][j] for u in range(4)], np.uint32)
                off = swizzle_offset(4 * p + j, o)
                smem[stage + off:stage + off + 16] = v.view(np.uint8)
                writes[off // 16] += 1
        assert (writes == 1).all()             # a bijection onto the stage
        if c == 0:
            # K9's nodot reads x[r, 0] of each row from here: the first
            # element of the row's piece 0, widened back from bf16.
            x0 = np.array([smem[stage + swizzle_offset(r, 0):][:elem]
                           .view(NP_TYPE[form])[0]
                           for r in range(T["kSeg"])])
            if form == "bf16":
                x0 = (x0.astype(np.uint32) << 16).view(np.float32)
            np.testing.assert_array_equal(x0, seg_codes[:, 0])
        view = smem.view(NP_TYPE[form])
        for k in range(H["kSwizzleBytes"] // H["kKStepBytes"]):
            desc = smem_desc(stage + k * H["kKStepBytes"])
            got = view[hw_addresses(desc, T["kSeg"], elem) // elem]
            dims = c * chunk + width * k + np.arange(width)
            want = np.zeros((T["kSeg"], width), NP_TYPE[form])
            live = dims < dim
            want[:, live] = (_bf16_bits(seg_codes[:, dims[live]])
                             if form == "bf16" else seg_codes[:, dims[live]])
            np.testing.assert_array_equal(got, want)   # B[k][r], tail 0


@pytest.mark.parametrize("dim", TILED_DIMS)
@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("tile_n", list(TILED_SHAPES))
def test_tiled_staging_feeds_each_k16_descriptor_its_codes(tile_n, where,
                                                           dim):
    _check_tiled_staging(tile_n, where, dim, "bf16")


@pytest.mark.parametrize("dim", TILED_DIMS_S8)
@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("tile_n", list(TILED_SHAPES))
def test_tiled_s8_staging_feeds_each_k32_descriptor_its_codes(tile_n, where,
                                                              dim):
    _check_tiled_staging(tile_n, where, dim, "s8")


def test_tiled_code_stores_are_free_of_bank_conflicts():
    # A 16-byte store is served a quarter-warp at a time: each 8
    # consecutive lanes must hit the 8 distinct 16-byte bank groups. Both
    # forms store piece o of rows 4 p + j; a piece is 8 bf16 or 16 int8
    # dims, so the map (and this check) is the same for both.
    for form in FORMS:
        assert 2 * T["kDimGroups"] * piece_dims(form) == CHUNK[form]
        for j in range(4):
            for tid0 in range(0, T["kThreads"], 8):
                groups = set()
                for tid in range(tid0, tid0 + 8):
                    o, p = tiled_thread(tid)
                    groups.add((swizzle_offset(4 * p + j, o) % 128) // 16)
                assert len(groups) == 8


def tiled_plan(n_queries: int, dim: int, form: str = "bf16"):
    """(m_tiles, stream_q, bytes) of the tiled kernel's launch choice."""
    n_chunks = -(-dim // CHUNK[form])

    def total(m_tiles, stream):
        q_chunk = 2 * T["kMTile"] * m_tiles * H["kSwizzleBytes"]
        stage = TILED_STAGE + (q_chunk if stream else 0)
        return (H["kAtomBytes"] + T["kStages"] * stage
                + (0 if stream else q_chunk * n_chunks)
                + 2 * T["kSeg"] * 4 * 2)         # two segments' stats
    if n_queries > 2 * T["kMTile"] and total(2, False) <= T["kMaxSmem"]:
        return 2, False, total(2, False)
    if total(1, False) <= T["kMaxSmem"]:
        return 1, False, total(1, False)
    return 1, True, total(1, True)


@pytest.mark.parametrize("dim", TILED_DIMS + [384, 768, 1024])
@pytest.mark.parametrize("n_queries", [128, 256])
def test_tiled_shared_memory_plan_fits(n_queries, dim):
    m_tiles, stream, total = tiled_plan(n_queries, dim)
    assert total <= T["kMaxSmem"]
    assert stream == (dim > 768)
    assert m_tiles == (2 if n_queries > 128 and dim <= 384 else 1)
    if dim in TILED_DIMS:
        assert not stream and m_tiles == n_queries // 128
    if n_queries <= 128 and dim <= 320:
        # Two blocks share an SM (228 KB, 1 KB reserved a block).
        assert 2 * (total + 1024) <= 233472
    assert "n_queries > q_rows<1>() && smem_bytes<Q, 2, false>(dim)" \
        in TILED_SRC


@pytest.mark.parametrize("dim", TILED_DIMS_S8 + [768, 1024, 1536, 2048])
@pytest.mark.parametrize("n_queries", [128, 256])
def test_tiled_s8_shared_memory_plan_fits(n_queries, dim):
    # 128 int8 dims a K-chunk: 256 resident queries to d = 768, 128 to
    # d = 1536, then 128 streamed.
    m_tiles, stream, total = tiled_plan(n_queries, dim, "s8")
    assert total <= T["kMaxSmem"]
    assert stream == (dim > 1536)
    assert m_tiles == (2 if n_queries > 128 and dim <= 768 else 1)
    # One block an SM in this form: two would leave a thread 128
    # registers, under which it spills.
    assert "kThreads, kMTiles == 1 && !kStreamQ && sizeof(Q) == 2 ? 2 : 1)" \
        in TILED_SRC
    assert "const int64_t n_chunks = (dim + chunk_dims<Q>() - 1) / " \
        "chunk_dims<Q>();" in TILED_SRC


def tiled_outputs(m: np.ndarray, g: int, bw: int, has_out2: bool,
                  m_tiles: int):
    """The kernel's grid, strips, epilogue and group minima over segment
    minima m (B, n_seg): (out1, writes of each out1 slot, out2, writes of
    each out2 slot)."""
    n_queries, n_seg = m.shape
    strip = bw if bw >= T["kStrip"] else bw * (T["kStrip"] // bw)
    q_rows = 2 * T["kMTile"] * m_tiles
    n_qtiles = -(-n_queries // q_rows)
    n_blocks = n_qtiles * -(-n_seg // strip)
    out1 = np.full(n_seg * n_queries, np.nan)
    out2 = np.full(n_seg // bw * n_queries, np.nan)
    n1 = np.zeros(out1.size, np.int64)
    n2 = np.zeros(out2.size, np.int64)
    for blk in range(n_blocks):
        q0 = (blk % n_qtiles) * q_rows
        seg0 = (blk // n_qtiles) * strip
        qi = q0 + np.arange(q_rows)
        live = qi < n_queries
        gmin = np.full(q_rows, np.inf)
        step, gi = divmod(seg0, g)
        gq, gpos = gi // bw, 0
        for seg in range(seg0, min(seg0 + strip, n_seg)):
            assert (step, gi) == (seg // g, seg % g)
            assert gq == seg % g // bw or not has_out2   # read with out2
            v = m[np.minimum(qi, n_queries - 1), seg]
            idx = (step * n_queries + qi[live]) * g + gi
            out1[idx] = v[live]
            n1[idx] += 1
            gmin = np.minimum(gmin, v)
            gpos += has_out2
            if has_out2 and gpos == bw:
                idx = (step * n_queries + qi[live]) * (g // bw) + gq
                out2[idx] = gmin[live]
                n2[idx] += 1
                gmin[:] = np.inf
                gpos, gq = 0, gq + 1
            gi += 1
            if gi == g:
                gi, gq, step = 0, 0, step + 1
    return out1, n1, out2, n2


#: (kernel, n_tiles, tile_n): K5 at bw 128 and 16 (12 and 6 tiles, not
#: multiples of 8, so 4 and 2 tiles a step), K2 over 12 tiles, K4 over 200
#: segments (a ragged last strip).
OUTPUT_CASES = {"k5_bw128": (12, 4096), "k5_bw16": (6, 4096),
                "k2": (12, 4096), "k4": (200, 128)}


@pytest.mark.parametrize("n_queries", [1, 128, 200, 256, 300])
@pytest.mark.parametrize("case", list(OUTPUT_CASES))
def test_tiled_outputs_are_each_written_once(case, n_queries):
    from smqtk_indexing_tpu_torch.ops.fused_scan import step_shape
    n_tiles, tile_n = OUTPUT_CASES[case]
    n_seg = n_tiles * tile_n // T["kSeg"]
    if case.startswith("k5"):
        n_steps, g, bw = step_shape(n_tiles, tile_n)
        assert n_tiles % 8 and bw == int(case[len("k5_bw"):])
    else:
        n_steps, g, bw = 1, n_seg, 1
    m_tiles, _, _ = tiled_plan(n_queries, 128)
    m = np.random.default_rng(n_queries).random((n_queries, n_seg))
    out1, n1, out2, n2 = tiled_outputs(m, g, bw, case.startswith("k5"),
                                       m_tiles)
    assert (n1 == 1).all()
    m1 = m.reshape(n_queries, n_steps, g).transpose(1, 0, 2)
    np.testing.assert_array_equal(out1.reshape(n_steps, n_queries, g), m1)
    if case.startswith("k5"):
        assert (n2 == 1).all()
        np.testing.assert_array_equal(
            out2.reshape(n_steps, n_queries, g // bw),
            m1.reshape(n_steps, n_queries, g // bw, bw).min(-1))
    else:
        assert not n2.any()


# -- K9: the variant epilogues of the tiled kernel --------------------------

K9_LINES = (
    "const int r = 8 * (e / 2) + 2 * (lane & 3) + e % 2;",
    "const uint8_t* x = chunk0 + swizzle_offset(r, 0);",
    "v = fminf(v, (a.x - 2.0f * x0[2 * jj]) + b.x);",
    "if ((seg0 + j) % nseg_t == 0) {",
    "const int col = 8 * jj + 2 * (lane & 3) + e;",
    "if (col < nseg_t && qi < n_queries) {",
    "out1[(step * n_queries + qi) * g + gi + col] =",
    "(sv[e] - 2.0f * inner(acc[i][4 * jj + 2 * h + e],",
    "V != kNoMin && (lane & 3) == 0 && qi < n_queries;",
    "if (tid < (V == kFolded ? 1 : 2) * 32 && j < n_segs) {",
    "(V == kNoMin && tile_n / kSeg > kSeg)) {",
)


def test_k9_epilogue_source_matches_the_model():
    for line in K9_LINES:
        assert line in TILED_SRC, line
    # nodot's x0[2 jj + e] is column 8 jj + 2 (lane % 4) + e: the fold's
    # fragment columns (test_accumulator_fragment_and_quad_reduction).
    for lane in range(32):
        cols = [8 * (e // 2) + 2 * (lane & 3) + e % 2 for e in range(32)]
        assert cols == [8 * jj + 2 * (lane % 4) + e for jj in range(16)
                        for e in range(2)]


def k9_nomin_outputs(scores: np.ndarray, g: int, nseg_t: int, m_tiles: int):
    """K9 nomin's writes over (B, N) scores: (out1, writes of each slot).
    A block of a strip writes, for each of its segments that opens a
    tile, the scores of the segment's rows below nseg_t into the tile's
    slots, from the fragment's (query, column) map."""
    n_queries, n_rows = scores.shape
    n_seg = n_rows // T["kSeg"]
    strip = T["kStrip"]
    q_rows = 2 * T["kMTile"] * m_tiles
    n_qtiles = -(-n_queries // q_rows)
    out1 = np.full(n_seg * n_queries, np.nan)
    n1 = np.zeros(out1.size, np.int64)
    for blk in range(n_qtiles * -(-n_seg // strip)):
        q0 = (blk % n_qtiles) * q_rows
        seg0 = (blk // n_qtiles) * strip
        for seg in range(seg0, min(seg0 + strip, n_seg)):
            if seg % nseg_t:
                continue
            step, gi = divmod(seg, g)
            for t in range(256):                     # two warpgroups
                wg, warp, lane = t // 128, (t // 32) % 4, t % 32
                for i in range(m_tiles):
                    for h in range(2):
                        qi = q0 + (wg * m_tiles + i) * T["kMTile"] \
                            + warp * 16 + lane // 4 + 8 * h
                        for jj in range(16):
                            for e in range(2):
                                col = 8 * jj + 2 * (lane & 3) + e
                                if col < nseg_t and qi < n_queries:
                                    idx = (step * n_queries + qi) * g \
                                        + gi + col
                                    out1[idx] = scores[qi, seg * 128 + col]
                                    n1[idx] += 1
    return out1, n1


@pytest.mark.parametrize("t_step", [2, 4, 8])
@pytest.mark.parametrize("n_queries", [1, 200])
def test_k9_outputs_are_each_written_once(t_step, n_queries):
    # K9 runs K2's strip of kStrip segments with g = t_step * tile_n / 128
    # and bw = 1: every step-major slot once, for t_step 2 and 4 as for
    # production's 8; nomin fills each tile's tile_n / 128 slots with its
    # first rows' scores.
    from smqtk_indexing_tpu_torch.tools.stage1_analysis import steps
    n_tiles, tile_n = 12, 1024
    nseg_t = tile_n // T["kSeg"]
    n_seg = n_tiles * nseg_t
    g = steps(n_tiles, t_step) * nseg_t
    n_steps = n_seg // g
    m_tiles, _, _ = tiled_plan(n_queries, 128)
    m = np.random.default_rng(t_step).random((n_queries, n_seg))
    out1, n1, _, n2 = tiled_outputs(m, g, 1, False, m_tiles)
    assert (n1 == 1).all() and not n2.any()
    np.testing.assert_array_equal(
        out1.reshape(n_steps, n_queries, g),
        m.reshape(n_queries, n_steps, g).transpose(1, 0, 2))
    scores = np.random.default_rng(t_step + 1).random(
        (n_queries, n_seg * T["kSeg"]))
    out1, n1 = k9_nomin_outputs(scores, g, nseg_t, m_tiles)
    assert (n1 == 1).all()
    first = (np.arange(n_tiles)[:, None] * tile_n
             + np.arange(nseg_t)).reshape(-1)
    np.testing.assert_array_equal(
        out1.reshape(n_steps, n_queries, g),
        scores[:, first].reshape(n_queries, n_steps, g).transpose(1, 0, 2))
