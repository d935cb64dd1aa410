"""
The port's ITQ and random-projection hashing (``ops/itq.py``,
``models/lsh_functor/``) against the JAX package's, on numpy inputs made
from a seed.

A fit is not bit-equal across backends (eigenvector signs and summation
order differ), so hashing is compared on one model carried across (the
``.npy`` cache elements both functors read and write), and a fit by its
invariants: an orthogonal rotation and the quantisation loss of the JAX
fit from the same initial rotation.
"""
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.data import DataMemoryElement as JaxDataElement
from smqtk_indexing_tpu.data.descriptor import (
    DescriptorMemoryElement as JaxElement,
)
from smqtk_indexing_tpu.models.lsh_functor import (
    ItqFunctor as JaxItq, SimpleRPFunctor as JaxRP,
)
from smqtk_indexing_tpu.ops import itq as jax_itq
from smqtk_indexing_tpu_torch.core.configuration import from_config_dict
from smqtk_indexing_tpu_torch.data import DataMemoryElement
from smqtk_indexing_tpu_torch.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu_torch.interfaces.lsh_functor import LshFunctor
from smqtk_indexing_tpu_torch.models.lsh_functor import (
    ItqFunctor, SimpleRPFunctor,
)
from smqtk_indexing_tpu_torch.ops import itq

torch.set_num_threads(1)

#: Hash bits may differ only where |z| is below this: the two products sum
#: in different orders, ~1e-6 of |x| |rotation| apart.
Z_EPS = 1e-5
#: A fit's quantisation loss against the JAX fit's from the same initial
#: rotation: the eigenvector signs may differ, and the 50 rotation steps
#: then settle in a nearby optimum.
LOSS_RTOL = 0.02


def _data(n, d, seed, clusters=20):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(clusters, d)) * 3
    x = c[rng.integers(0, clusters, n)] + rng.normal(size=(n, d))
    return x.astype(np.float32)


def _z64(x, mean, rot, normalize=None):
    x = x.astype(np.float64)
    if normalize is not None:
        nrm = np.linalg.norm(x, ord=normalize, axis=-1, keepdims=True)
        x = x / np.where(nrm == 0, 1.0, nrm)
    return (x - mean.astype(np.float64)) @ rot.astype(np.float64)


def _assert_same_hash(h, h_ref, z):
    assert h.dtype == bool and h.shape == h_ref.shape
    differ = h != h_ref
    assert (np.abs(z[differ]) < Z_EPS).all()


def _loss(x, mean, rot):
    z = _z64(x, mean, rot)
    return ((np.where(z >= 0, 1.0, -1.0) - z) ** 2).sum() / len(x)


@pytest.mark.parametrize("n,d,bits", [(2000, 32, 16), (3000, 64, 32)])
def test_hash_batch_matches_jax_on_one_model(n, d, bits):
    x = _data(n, d, seed=bits)
    r0 = np.random.default_rng(1).standard_normal((bits, bits)) \
        .astype(np.float32)
    mean, rot = (np.array(a) for a in jax_itq.itq_fit(
        jnp.asarray(x), jnp.asarray(r0), bits=bits, n_iter=10))
    h_ref = np.asarray(jax_itq.hash_batch(jnp.asarray(x), mean, rot))
    h = itq.hash_batch(torch.from_numpy(x), torch.from_numpy(mean),
                       torch.from_numpy(rot)).numpy()
    _assert_same_hash(h, h_ref, _z64(x, mean, rot))


@pytest.mark.parametrize("n,d,bits", [(2000, 32, 16), (2000, 24, 24)])
def test_itq_fit_invariants(n, d, bits):
    x = _data(n, d, seed=d)
    r0 = np.random.default_rng(2).standard_normal((bits, bits)) \
        .astype(np.float32)
    mean, rot = itq.itq_fit(torch.from_numpy(x), torch.from_numpy(r0),
                            bits=bits, n_iter=50)
    mean, rot = mean.numpy(), rot.numpy()
    assert rot.shape == (d, bits) and rot.dtype == np.float32
    j_mean, j_rot = (np.asarray(a) for a in jax_itq.itq_fit(
        jnp.asarray(x), jnp.asarray(r0), bits=bits, n_iter=50))
    np.testing.assert_allclose(mean, j_mean, rtol=1e-5, atol=1e-5)
    assert _loss(x, mean, rot) == pytest.approx(_loss(x, j_mean, j_rot),
                                                rel=LOSS_RTOL)
    if bits == 16:
        # Well conditioned here: 16 Newton-Schulz steps converge.
        np.testing.assert_allclose(rot.T @ rot, np.eye(bits), atol=1e-5)


def test_polar_is_orthogonal():
    m = np.random.default_rng(3).standard_normal((32, 32)) \
        .astype(np.float32)
    p = itq._polar(torch.from_numpy(m), steps=40).numpy()
    np.testing.assert_allclose(p @ p.T, np.eye(32), atol=1e-5)


def _jax_itq(x, bits, **kw):
    mv, rot = JaxDataElement(), JaxDataElement()
    f = JaxItq(mv, rot, bit_length=bits, random_seed=0, **kw)
    f.fit([JaxElement(i, v) for i, v in enumerate(x)])
    return f, mv, rot


@pytest.mark.parametrize("normalize", [None, 2])
def test_jax_model_loads_and_hashes_alike(normalize):
    x = _data(1500, 32, seed=4)
    jf, mv, rot = _jax_itq(x, 16, normalize=normalize)
    pf = ItqFunctor(DataMemoryElement(mv.get_bytes()),
                    DataMemoryElement(rot.get_bytes()), bit_length=16,
                    normalize=normalize, device="cpu")
    assert pf.has_model()
    mean, proj, norm = pf.hash_model()
    j_mean, j_proj, j_norm = jf.hash_model()
    assert np.array_equal(mean, j_mean) and np.array_equal(proj, j_proj)
    assert norm == j_norm == normalize
    _assert_same_hash(pf.get_hash_batch(x), jf.get_hash_batch(x),
                      _z64(x, mean, proj, normalize))
    assert np.array_equal(pf.get_hash(x[3]), pf.get_hash_batch(x[3:4])[0])


def test_port_model_loads_into_jax():
    x = _data(1500, 32, seed=5)
    mv, rot = DataMemoryElement(), DataMemoryElement()
    pf = ItqFunctor(mv, rot, bit_length=16, random_seed=0, device="cpu")
    pf.fit([DescriptorMemoryElement(i, v) for i, v in enumerate(x)])
    for elem in (mv, rot):
        arr = np.load(io.BytesIO(elem.get_bytes()))
        assert arr.dtype == np.float32
    jf = JaxItq(JaxDataElement(mv.get_bytes()),
                JaxDataElement(rot.get_bytes()), bit_length=16)
    mean, proj, _ = pf.hash_model()
    _assert_same_hash(pf.get_hash_batch(x), jf.get_hash_batch(x),
                      _z64(x, mean, proj))


def test_itq_functor_guards_and_config():
    x = _data(100, 8, seed=6)
    els = [DescriptorMemoryElement(i, v) for i, v in enumerate(x)]
    f = ItqFunctor(bit_length=4, random_seed=0, device="cpu")
    with pytest.raises(RuntimeError):
        f.get_hash(x[0])
    with pytest.raises(ValueError):
        f.fit([])
    with pytest.raises(ValueError):
        ItqFunctor(bit_length=16, device="cpu").fit(els)
    f.fit(els)
    with pytest.raises(RuntimeError):
        f.fit(els)
    cfg = f.get_config()
    json.dumps(cfg)
    assert cfg["device"] == "cpu" and cfg["bit_length"] == 4
    g = ItqFunctor.from_config(cfg)
    assert g.get_config() == cfg and not g.has_model()


def test_simple_rp_same_seed_same_model():
    x = _data(300, 24, seed=7)
    jf = JaxRP(bit_length=12, random_seed=9)
    j_mean = jf.fit([JaxElement(i, v) for i, v in enumerate(x)])
    pf = SimpleRPFunctor(bit_length=12, random_seed=9, device="cpu")
    mean = pf.fit([DescriptorMemoryElement(i, v) for i, v in enumerate(x)])
    assert np.array_equal(mean, np.asarray(j_mean))
    p_mean, p_rps, _ = pf.hash_model()
    q_mean, q_rps, _ = jf.hash_model()
    assert np.array_equal(p_mean, q_mean) and np.array_equal(p_rps, q_rps)
    _assert_same_hash(pf.get_hash_batch(x), jf.get_hash_batch(x),
                      _z64(x, p_mean, p_rps))
    cfg = pf.get_config()
    assert cfg == {"bit_length": 12, "normalize": None, "random_seed": 9,
                   "device": "cpu"}
    assert SimpleRPFunctor.from_config(cfg).get_config() == cfg


@pytest.mark.parametrize("name", ["ItqFunctor", "SimpleRPFunctor"])
def test_bare_names_resolve_to_the_port(name):
    impls = LshFunctor.get_impls()
    assert {c.__name__ for c in impls} >= {"ItqFunctor", "SimpleRPFunctor"}
    assert all(c.__module__.startswith("smqtk_indexing_tpu_torch.")
               for c in impls)
    f = from_config_dict({"type": name, name: {"device": "cpu"}}, impls)
    assert type(f).__module__.startswith(
        "smqtk_indexing_tpu_torch.models.lsh_functor.")


@pytest.mark.parametrize("cls", [ItqFunctor, SimpleRPFunctor])
def test_default_device_is_the_card(cls):
    if torch.cuda.is_available():
        assert cls(bit_length=4).device == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            cls(bit_length=4)
