"""
A numpy model of the shared-memory layout that K1's ``wgmma`` kernel
(``csrc/segment_minima_wgmma.cu``) stages and that its descriptors ask the
tensor cores to read (``csrc/wgmma.cuh``). It checks, with no card:

- that the ``cp.async`` staging map (db rows, query rows) and the int8
  widening map are bijections onto their 128-byte-swizzle tiles;
- that every k16 step's descriptor (start address, LBO, SBO, layout type)
  reads back the (64 or 128) x 16 operand slice in wgmma's order, for the
  query tile (A) and the database tile (B), at d = 128 and d = 1024, with
  the query tile resident or streamed through the ring;
- the shared-memory plan (which variant each d takes, tile alignment),
  the accumulator fragment the epilogue reduces, and the exact int8 ->
  bf16 widening.

The hardware's side of the model is the PTX ISA's K-major 128-byte swizzle
layout: an operand row r, K offset kk of a k16 step lies at the logical
address ``start + (r // 8) * SBO + (r % 8) * 128 + kk * 2`` (LBO unused),
and the swizzle XORs address bits 4-6 with bits 7-9. The kernel's side is
read from the sources, so the model and the kernel cannot drift apart.
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
K = _constants("segment_minima_wgmma.cu")
KERNEL_SRC = (CSRC / "segment_minima_wgmma.cu").read_text()

#: The PTX ISA's geometry of a K-major operand with 128-byte swizzle: rows
#: of 128 bytes, 8-row core groups, bf16 values, 16-byte pieces.
HW_ROW_BYTES = 128
HW_CORE_ROWS = 8
HW_ELEM_BYTES = 2


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


def hw_address(desc: int, row: int, kk: int) -> int:
    """The shared byte address the tensor cores read for operand row
    ``row``, K offset ``kk`` (0..15) of the k16 step that ``desc``
    describes (PTX ISA: matrix descriptor, K-major, 128-byte swizzle)."""
    start = (desc & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    assert desc >> 62 == 1, "layout type must be the 128-byte swizzle"
    assert (desc >> 49) & 7 == 0, "base offset must be 0"
    logical = (start + (row // HW_CORE_ROWS) * sbo
               + (row % HW_CORE_ROWS) * HW_ROW_BYTES + kk * HW_ELEM_BYTES)
    return logical ^ (((logical >> 7) & 7) << 4)


def stage_rows(smem: np.ndarray, base: int, mat: np.ndarray) -> None:
    """Write a (rows, 64) uint16 K-chunk into ``smem`` at ``base`` the way
    ``copy_chunk`` does: thread t copies pieces i = t + kThreads j."""
    rows = mat.shape[0]
    raw = mat.view(np.uint8).reshape(rows, -1)
    for tid in range(K["kThreads"]):
        for j in range(rows * 8 // K["kThreads"]):
            i = tid + j * K["kThreads"]
            r, p = i >> 3, i & 7
            dst = base + swizzle_offset(r, p)
            smem[dst:dst + 16] = raw[r, 16 * p:16 * p + 16]


def read_operand(smem: np.ndarray, desc: int, rows: int) -> np.ndarray:
    """The (rows, 16) uint16 slice the tensor cores read through desc."""
    out = np.empty((rows, 16), np.uint16)
    for r in range(rows):
        for kk in range(16):
            a = hw_address(desc, r, kk)
            out[r, kk] = smem[a:a + 2].view(np.uint16)[0]
    return out


def smem_plan(dim: int):
    """(m_tiles, stream_q, bytes) of the kernel's launch choice."""
    ring_db = K["kStages"] * K["kSeg"] * H["kSwizzleBytes"]
    for m_tiles, stream in ((2, False), (1, False), (2, True)):
        q_rows = 2 * K["kMTile"] * m_tiles
        q_chunk = q_rows * H["kSwizzleBytes"]
        total = H["kAtomBytes"] + ring_db + (
            K["kStages"] * q_chunk if stream
            else q_chunk * (dim // K["kChunk"]))
        if total <= K["kMaxSmem"] or stream:
            return m_tiles, stream, total


def test_header_constants_match_the_hardware_geometry():
    assert H["kSwizzleBytes"] == HW_ROW_BYTES
    assert H["kAtomRows"] == HW_CORE_ROWS
    assert H["kAtomBytes"] == HW_CORE_ROWS * HW_ROW_BYTES
    assert H["kSboBytes"] == H["kAtomBytes"]   # row groups back to back
    assert H["kK16Bytes"] == 16 * HW_ELEM_BYTES
    assert H["kPieceBytes"] * 8 == H["kSwizzleBytes"]
    assert K["kChunk"] * HW_ELEM_BYTES == H["kSwizzleBytes"]
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
    # store_codes: thread t widens codes [32 (t % 2), +32) of row t / 2
    # into logical pieces 4 (t % 2) + p, p < 4 (8 codes a piece).
    seen = np.zeros(K["kSeg"] * 8, np.int64)
    for tid in range(K["kThreads"]):
        r, half = tid >> 1, tid & 1
        for p in range(4):
            piece = 4 * half + p
            assert (32 * half + 8 * p) // 8 == piece   # codes stay in order
            seen[swizzle_offset(r, piece) // 16] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dim,operand,stream", [
    (128, "A", False), (128, "B", False),
    (1024, "A", True), (1024, "B", True), (512, "A", False)])
def test_each_k16_descriptor_reads_its_operand_slice(dim, operand, stream):
    m_tiles, stream_plan, total = smem_plan(dim)
    assert stream_plan == stream
    rng = np.random.default_rng(dim)
    q_rows = 2 * K["kMTile"] * m_tiles
    rows = q_rows if operand == "A" else K["kSeg"]
    mat = rng.integers(0, 1 << 16, size=(rows, dim)).astype(np.uint16)
    # The kernel's ring starts on the first 1024-byte boundary of dynamic
    # shared memory, which need not be aligned itself.
    raw = 48
    ring = (raw + H["kAtomBytes"] - 1) & ~(H["kAtomBytes"] - 1)
    db_stage = K["kSeg"] * H["kSwizzleBytes"]
    stage_bytes = db_stage + (q_rows * H["kSwizzleBytes"] if stream else 0)
    q_res = ring + K["kStages"] * stage_bytes
    smem = np.zeros(ring + total, np.uint8)
    for c in range(dim // K["kChunk"]):
        stage = ring + (c % K["kStages"]) * stage_bytes
        if operand == "B":
            tile = stage
        elif stream:
            tile = stage + db_stage
        else:
            tile = q_res + c * q_rows * H["kSwizzleBytes"]
        assert tile % H["kAtomBytes"] == 0
        chunk = np.ascontiguousarray(mat[:, c * K["kChunk"]:
                                         (c + 1) * K["kChunk"]])
        stage_rows(smem, tile, chunk)
        for k in range(K["kChunk"] // 16):
            cols = slice(c * K["kChunk"] + 16 * k,
                         c * K["kChunk"] + 16 * k + 16)
            if operand == "B":
                desc = smem_desc(tile + k * H["kK16Bytes"])
                assert np.array_equal(read_operand(smem, desc, rows),
                                      mat[:, cols])
                continue
            for wg in range(2):
                for i in range(m_tiles):
                    m0 = (wg * m_tiles + i) * K["kMTile"]
                    desc = smem_desc(tile + m0 * H["kSwizzleBytes"]
                                     + k * H["kK16Bytes"])
                    got = read_operand(smem, desc, K["kMTile"])
                    assert np.array_equal(got, mat[m0:m0 + 64, cols])


@pytest.mark.parametrize("dim", [128, 256, 384, 640, 768, 1024, 4096])
def test_shared_memory_plan_fits(dim):
    m_tiles, stream, total = smem_plan(dim)
    assert total <= K["kMaxSmem"]
    assert stream == (dim > 640)
    assert m_tiles == (1 if 256 < dim <= 640 else 2)


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
    assert "__shfl_xor_sync(0xffffffffu, v, 1)" in KERNEL_SRC
    assert "__shfl_xor_sync(0xffffffffu, v, 2)" in KERNEL_SRC


def _byte_perm(x: int, y: int, s: int) -> int:
    b = x | (y << 32)
    out = 0
    for i in range(4):
        sel = (s >> (4 * i)) & 0xF
        assert sel < 8       # no sign-replicate mode
        out |= ((b >> (8 * sel)) & 0xFF) << (8 * i)
    return out


def test_int8_codes_widen_exactly_to_bf16():
    fn = KERNEL_SRC[KERNEL_SRC.index("codes_to_bf16x2(uint32_t w"):]
    fn = fn[:fn.index("\n}")]
    magic = int(re.search(r"0x([0-9A-F]{8})u", fn).group(1), 16)
    offset = float(re.search(r"([0-9.]+)f;", fn).group(1))
    sel = int(re.search(r"0x(75\d0) \| k\)", fn).group(1), 16)
    pack = int(re.search(r"0x(7632)\)", fn).group(1), 16)
    assert "0x80808080u" in KERNEL_SRC
    codes = np.arange(-128, 128, dtype=np.int64)
    want = torch.from_numpy(codes.astype(np.float32)).to(torch.bfloat16) \
        .view(torch.int16).numpy().astype(np.uint16)
    for lo in range(0, 256, 2):
        w = ((int(codes[lo]) & 0xFF) | ((int(codes[lo + 1]) & 0xFF) << 8)) \
            ^ 0x8080
        fl = np.array([_byte_perm(w, magic, sel | k) for k in (0, 1)],
                      np.uint32).view(np.float32) - np.float32(offset)
        word = _byte_perm(int(fl.view(np.uint32)[0]),
                          int(fl.view(np.uint32)[1]), pack)
        assert word & 0xFFFF == want[lo]
        assert word >> 16 == want[lo + 1]
