"""
The port's stage-1 probes on the CPU (``smqtk_indexing_tpu_torch/tools/``):
K10's ``scan_minima`` and K9's ``run_variant`` run their plain versions
here and are held against the JAX package's probes run as its own tests
run Pallas (``interpret=True``). The JAX tools are imported by path; they
are not edited. Inputs are made with numpy from a seed and fed to both.
"""
import importlib.util
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from smqtk_indexing_tpu_torch.tools import probe_int8_mxu, stage1_analysis

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Stage-1 minima with a bf16-rounded query, port vs JAX: both sum exact
#: products (bf16 x int8) in f32 in different orders, so they differ by f32
#: rounding of the sum only: within 1e-5 of the largest score magnitude.
STAGE1_REL = 1e-5


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_k10 = _load("probe_int8_mxu")
jax_k9 = _load("stage1_analysis")


def _codes(shape, seed):
    return np.random.default_rng(seed).integers(-127, 128, size=shape) \
        .astype(np.int8)


def _assert_minima(out, ref, exact):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    if exact:
        np.testing.assert_array_equal(out, ref)
        return
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=0,
                               atol=STAGE1_REL * np.abs(ref[fin]).max())


# ---------------------------------------------------------------------------
# K10: tools/probe_int8_mxu.py scan_minima
# ---------------------------------------------------------------------------

def _k10_case():
    n, d, b = 8192, 128, 8
    rng = np.random.default_rng(0)
    db_t = _codes((d, n), 1)
    sq = (db_t.astype(np.float32) ** 2).sum(0, keepdims=True)
    pen = np.where(rng.random((1, n)) < 0.02, np.inf, 0.0).astype(np.float32)
    pen[:, 128:256] = np.inf                     # a wholly dead segment
    qf = rng.normal(size=(b, d)).astype(np.float32)
    g = np.float32(np.abs(qf).max() / 127.0)
    q_i8 = np.clip(np.rint(qf / g), -127, 127).astype(np.int8)
    return db_t, sq, pen, qf, q_i8, g


@pytest.mark.parametrize("int8dot", [True, False])
def test_k10_plain_version_matches_pallas(int8dot):
    db_t, sq, pen, qf, q_i8, g = _k10_case()
    q = q_i8 if int8dot else qf
    q_jax = jnp.asarray(q_i8) if int8dot \
        else jnp.asarray(qf).astype(jnp.bfloat16)
    ref = jax_k10.scan_minima(
        jnp.asarray(db_t), jnp.asarray(sq), jnp.asarray(pen), q_jax,
        jnp.full((1, 1), g, jnp.float32), int8dot=int8dot, interpret=True)
    before = dict(probe_int8_mxu.LAUNCHES)
    out = probe_int8_mxu.scan_minima(
        torch.from_numpy(db_t), torch.from_numpy(sq), torch.from_numpy(pen),
        torch.from_numpy(q), float(g), int8dot=int8dot)
    # The plain version on CPU tensors is not a kernel launch.
    assert probe_int8_mxu.LAUNCHES == before
    assert out.shape == (8, 64)
    assert np.isinf(out.numpy()[:, 1]).all()
    # int8 x int8 products are integers: the two agree bit for bit.
    _assert_minima(out, ref, exact=int8dot)


def test_k10_quantise_and_overlap():
    _, _, _, qf, q_i8, g = _k10_case()
    q, g_port = probe_int8_mxu.quantise(torch.from_numpy(qf))
    assert g_port == float(g)
    np.testing.assert_array_equal(q.numpy(), q_i8)
    m = torch.from_numpy(np.random.default_rng(2).random((4, 100))
                         .astype(np.float32))
    assert probe_int8_mxu.overlap(m, m).tolist() == [1.0] * 4
    assert probe_int8_mxu.overlap(m, -m, s_keep=50).max().item() == 0.0
    with pytest.raises(TypeError, match="int8dot"):
        probe_int8_mxu.scan_minima(torch.zeros((128, 256), dtype=torch.int8),
                                   torch.zeros(256), torch.zeros(256),
                                   torch.zeros((4, 128)), 1.0, int8dot=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            probe_int8_mxu.make_inputs("cuda", n=256)


# ---------------------------------------------------------------------------
# K9: tools/stage1_analysis.py _run_variant -> _variant_kernel
# ---------------------------------------------------------------------------

N_TILES, TILE, D, B = 6, 512, 128, 8


def _k9_case():
    rng = np.random.default_rng(3)
    db3 = _codes((N_TILES, D, TILE), 4)
    n = N_TILES * TILE
    sq = (rng.random((1, n)) * 500).astype(np.float32)
    pen = np.where(rng.random((1, n)) < 0.03, np.inf, 0.0).astype(np.float32)
    pen[:, 512:640] = np.inf                     # a wholly dead segment
    qf = (rng.normal(size=(B, D)) * 0.2).astype(np.float32)
    q_i8 = rng.integers(-127, 128, size=(B, D)).astype(np.int8)
    return db3, sq, pen, qf, q_i8


@partial(jax.jit, static_argnames=("variant", "t_step"))
def _jax_variant_out(db3, db_sq, penalty, q, *, variant, t_step):
    """``_run_variant``'s pallas_call (``stage1_analysis.py:166-195``),
    its specs as they are, returning the whole output instead of its
    scalar."""
    n_tiles, d, tile_n = db3.shape
    nseg_t = tile_n // jax_k9.SEG
    b = q.shape[0]
    while n_tiles % t_step:
        t_step //= 2
    n_steps = n_tiles // t_step
    q3 = jax_k9._q_kernel_dtype(q, db3.dtype).reshape(1, b, d)
    kernel = partial(jax_k9._variant_kernel, mode="native", variant=variant)
    return pl.pallas_call(
        kernel,
        grid=(1, n_steps),
        in_specs=[
            pl.BlockSpec((1, b, d), lambda qi, ni: (qi, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((t_step, d, tile_n), lambda qi, ni: (ni, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, t_step * tile_n), lambda qi, ni: (0, ni),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, t_step * tile_n), lambda qi, ni: (0, ni),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec(
            (1, b, t_step * nseg_t), lambda qi, ni: (ni, qi, 0),
            memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(
            (n_steps, b, t_step * nseg_t), jnp.float32),
        interpret=True,
    )(q3, db3, db_sq, penalty)


@pytest.mark.parametrize("query", ["int8", "bf16"])
@pytest.mark.parametrize("variant", stage1_analysis.VARIANTS)
def test_k9_variant_plain_version_matches_pallas(variant, query):
    db3, sq, pen, qf, q_i8 = _k9_case()
    q = q_i8 if query == "int8" else qf
    # 6 tiles: t_step 4 halves to 2, so 3 steps of 2 tiles.
    ref = _jax_variant_out(jnp.asarray(db3), jnp.asarray(sq),
                           jnp.asarray(pen), jnp.asarray(q),
                           variant=variant, t_step=4)
    before = dict(stage1_analysis.LAUNCHES)
    out = stage1_analysis.run_variant(
        torch.from_numpy(db3), torch.from_numpy(sq), torch.from_numpy(pen),
        torch.from_numpy(q), variant=variant, t_step=4)
    assert stage1_analysis.LAUNCHES == before
    assert out.shape == (3, B, 8)
    if variant == "nodot":
        # No products: every query's row is the same.
        assert (out == out[:, :1]).all()
    if variant in ("full", "bf16min") and query == "int8":
        # A wholly dead segment stays +inf (tile 1, segment 0).
        assert torch.isinf(out[0, :, 4]).all()
    exact = query == "int8" or variant == "nodot"
    if variant == "bf16min" and not exact:
        # f32 sums in another order may round to the neighbouring bf16.
        ref, out = np.asarray(ref), out.numpy()
        fin = np.isfinite(ref)
        np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
        np.testing.assert_allclose(out[fin], ref[fin], rtol=2.0 ** -8,
                                   atol=STAGE1_REL * np.abs(ref[fin]).max())
        return
    _assert_minima(out, ref, exact)


@pytest.mark.parametrize("variant", ["full", "nomin", "bf16min"])
def test_k9_scalar_matches_run_variant(variant):
    db3, sq, pen, _, q_i8 = _k9_case()
    ref = jax_k9._run_variant(jnp.asarray(db3), jnp.asarray(sq),
                              jnp.asarray(pen), jnp.asarray(q_i8),
                              variant=variant, t_step=8, interpret=True)
    out = stage1_analysis.run_variant(
        torch.from_numpy(db3), torch.from_numpy(sq), torch.from_numpy(pen),
        torch.from_numpy(q_i8), variant=variant, t_step=8)
    assert out.shape == (3, B, 8)                # 8 halves to 2 tiles a step
    got = stage1_analysis.sum_first_column(out).item()
    ref = float(ref)
    if np.isinf(ref):
        assert got == ref
    else:
        # The summed values are equal; their 24-term f32 sums, taken in
        # other orders, round apart by a few units of the last place each.
        col = out[:, :, 0].double()
        assert abs(got - ref) <= 24 * 2.0 ** -24 * col.abs().sum().item()


def test_k9_steps_variants_and_refusals():
    assert stage1_analysis.steps(24576, 8) == 8
    assert stage1_analysis.steps(6, 8) == 2
    assert stage1_analysis.steps(3, 4) == 1
    assert set(stage1_analysis.SAME_AS) == {"staged", "minfirst"}
    db3, sq, pen, qf, _ = _k9_case()
    args = [torch.from_numpy(x) for x in (db3, sq, pen, qf)]
    with pytest.raises(ValueError, match="unknown"):
        stage1_analysis.run_variant(*args, variant="fastest", t_step=2)
    with pytest.raises(ValueError, match="int8"):
        stage1_analysis.run_variant(args[0].float(), *args[1:],
                                    variant="full", t_step=2)
    # The card's ideal times: the codes at 3.35 TB/s, the products at the
    # tensor cores' bf16 and int8 rates.
    ideal = stage1_analysis.ideal(100663296, 128)
    assert abs(ideal["dma_ms"] - 3.846) < 1e-3
    assert abs(ideal["tc_bf16_ms"] / ideal["tc_int8_ms"] - 1979 / 989) < 1e-9
    with pytest.raises(ValueError, match="CUDA"):
        stage1_analysis.sweep(*args)


def test_k9_variant_map_matches_jax_and_the_kernel():
    # Every variant of the JAX probe (its main()'s list) is one of the
    # port's, each runs the tensor-core kernel's instantiation of the
    # Variant value it names, and staged / minfirst run full's.
    import ast
    import re
    src = open(os.path.join(REPO, "tools", "stage1_analysis.py")).read()
    listed = re.search(r"all_variants = (\([^)]*\))", src).group(1)
    assert set(ast.literal_eval(listed)) == set(stage1_analysis.VARIANTS)
    cu = (stage1_analysis.fused_scan._kernels.CSRC
          / "segment_minima_tiled_wgmma.cu").read_text()
    enum = dict((name, int(v)) for name, v in re.findall(
        r"(k\w+) = (\d)", cu[cu.index("enum Variant"):cu.index("};")]))
    names = {"full": "kFull", "folded": "kFolded", "nomin": "kNoMin",
             "nodot": "kNoDot", "bf16min": "kBf16Min"}
    for variant, value in stage1_analysis.KERNEL_VARIANT.items():
        ran = stage1_analysis.SAME_AS.get(variant, variant)
        assert value == enum[names[ran]], variant
        assert f"case {names[ran]}:\n      return launch<Q, {names[ran]}>(" \
            in cu
    assert set(stage1_analysis.LAUNCHES) == set(names)
    for entry, q in (("stage1_variant_i8", "uint16_t"),
                     ("stage1_variant_i8i8", "int8_t")):
        body = cu[cu.index(f'extern "C" int {entry}('):]
        assert f"return launch_probe<{q}>(" in body[:body.index("\n}")]


def test_bf16_ulp_is_the_spacing_above_each_value():
    # Every positive normal bf16 but the largest: the next bf16 up is the
    # value plus its ulp; the same magnitude for the negative ones; 0 at 0.
    bits = torch.arange(0x0080, 0x7F7F, dtype=torch.int32).to(torch.int16)
    v = bits.view(torch.bfloat16).float()
    up = (bits + 1).view(torch.bfloat16).float()
    ulp = stage1_analysis.bf16_ulp(v)
    assert torch.equal(ulp, up - v)
    assert torch.equal(stage1_analysis.bf16_ulp(-v), ulp)
    assert stage1_analysis.bf16_ulp(torch.zeros(1)).item() == 0.0
    # The case that needs it: 127.6 rounds to 127.5, or past 128 to 128.0
    # after a sum in another order; both lie within one ulp of 127.5.
    assert stage1_analysis.bf16_ulp(torch.tensor([127.5])).item() == 0.5
    assert stage1_analysis.bf16_ulp(torch.tensor([128.0])).item() == 1.0
