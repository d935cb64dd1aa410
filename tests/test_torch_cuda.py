"""
The port's hand-written kernels on the card, against their plain PyTorch
versions and against the port's CPU path. Every test here is marked
``cuda`` and skips without a card. This file imports neither jax nor the
JAX package's compute, so it runs on a machine with the card and no jax:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from smqtk_indexing_tpu_torch.data import DescriptorMemoryElement
from smqtk_indexing_tpu_torch.models.nn_index.flat import (
    FlatNearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.ops import fused_scan
from tests.test_torch_helpers import scan_inputs

torch.set_num_threads(1)

#: Kernel vs plain version: both sum exact f32 (or bf16 x bf16) products
#: in f32, so they differ by rounding only.
STAGE1_RTOL = 1e-5
#: Distances, card vs CPU: exact f32 formulas in different orders.
DIST_RTOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version(card, dtype):
    n, d, b = 4096, 256, 200  # a ragged query tile (200 = 128 + 72)
    db, sq, pen, q, _ = scan_inputs(n, d, b, seed=5)
    args = (torch.from_numpy(db).to(card, getattr(torch, dtype)),
            torch.from_numpy(sq).to(card), torch.from_numpy(pen).to(card),
            torch.from_numpy(q).to(card))
    before = fused_scan.LAUNCHES
    out = fused_scan.segment_minima(*args)
    torch.cuda.synchronize()
    assert fused_scan.LAUNCHES == before + 1
    ref = fused_scan.segment_minima_reference(*args)
    assert fused_scan.LAUNCHES == before + 1
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    assert torch.isinf(out[:, 1]).all()
    fin = torch.isfinite(ref)
    scale = ref[fin].abs().max().item()
    assert (out - ref)[fin].abs().max().item() <= STAGE1_RTOL * scale


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_the_kernel_cannot_take(card):
    db = torch.zeros((256, 64), device=card)
    vec = torch.zeros(256, device=card)
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_scan.segment_minima(db, vec, vec,
                                  torch.zeros((4, 64), device=card))
    db = torch.zeros((256, 256), device=card)[:, :128]
    with pytest.raises(ValueError, match="contiguous"):
        fused_scan.segment_minima(db, vec, vec,
                                  torch.zeros((4, 128), device=card))
    with pytest.raises(ValueError, match="several devices"):
        fused_scan.segment_minima(db.contiguous(), vec.cpu(), vec,
                                  torch.zeros((4, 128), device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["euclidean", "inner_product", "cosine"])
def test_flat_topk_fused_matches_cpu(card, metric):
    n, d, b, k = 8192, 128, 64, 10
    db, sq, _, q, valid = scan_inputs(n, d, b, seed=6)
    norm = np.sqrt(sq)
    cpu = [torch.from_numpy(a) for a in (db, sq, valid, q)]
    d_cpu, r_cpu = fused_scan.flat_topk_fused(
        *cpu, k=k, metric=metric, db_norm=torch.from_numpy(norm))
    d_gpu, r_gpu = fused_scan.flat_topk_fused(
        *(t.to(card) for t in cpu), k=k, metric=metric,
        db_norm=torch.from_numpy(norm).to(card))
    np.testing.assert_allclose(d_gpu.cpu().numpy(), d_cpu.numpy(),
                               rtol=DIST_RTOL, atol=1e-6)
    same = (r_gpu.cpu() == r_cpu).float().mean().item()
    assert same >= 0.99  # only near-tie swaps may differ


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_index_on_card_matches_cpu(card, dtype):
    rng = np.random.default_rng(7)
    x = rng.random((3000, 100), dtype=np.float32)
    els = [DescriptorMemoryElement(i, x[i]) for i in range(3000)]
    results = []
    for device in ("cuda", "cpu"):
        index = FlatNearestNeighborsIndex(dtype=dtype, device=device)
        index.build_index(els[:2500])
        index.update_index(els[2500:])
        index.remove_from_index(list(range(0, 3000, 7)))
        before = fused_scan.LAUNCHES
        res = index.nn_many(els[1:40:2], 5)
        assert (fused_scan.LAUNCHES > before) == (device == "cuda")
        results.append(res)
    for r_gpu, r_cpu in zip(*results):
        assert [e.uuid() for e in r_gpu[0]] == [e.uuid() for e in r_cpu[0]]
        np.testing.assert_allclose(r_gpu[1], r_cpu[1], rtol=DIST_RTOL,
                                   atol=1e-6)
    report = FlatNearestNeighborsIndex.usability_report()
    assert report["kernel_tier"] == "cuda" and report["degraded"] is False


@pytest.mark.cuda
def test_full_f32_policy_belongs_to_the_caller(card):
    db, sq, pen, q, valid = scan_inputs(1024, 128, 8, seed=8)
    db, sq, pen, q, valid = (torch.from_numpy(a).to(card)
                             for a in (db, sq, pen, q, valid))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        # The plain version's cuBLAS product refuses TF32 ...
        with pytest.raises(RuntimeError, match="allow_tf32"):
            fused_scan.segment_minima_reference(db, sq, pen, q)
        # ... while the fused path has no cuBLAS product and leaves the
        # caller's switch as it was.
        fused_scan.flat_topk_fused(db, sq, valid, q, k=5,
                                   metric="inner_product")
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
