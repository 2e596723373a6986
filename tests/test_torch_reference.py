"""Parity harness: the one place the port's tests reach the JAX reference.

The reference (``src/repro``) does not import under jax 0.9 as shipped:
``repro/models/transformer.py`` asks ``_barrier_p in
batching.primitive_batchers``, and that mapping is now a proxy without
``__contains__``. ``apply_jax_fix`` gives the proxy one that looks the key
up in ``batching.fancy_primitive_batchers``; nothing in ``src/repro`` is
edited. The fix is applied lazily, when the ``reference`` fixture first
runs, never while a module is imported: the suite's workers each collect
every test file, and a fix applied at collection would change which of the
reference's own test files collect. It is undone, and the reference
modules it let import are forgotten, when the fixture's test module ends,
so it never changes the outcome of a reference test that runs later in the
same worker.

The other ``tests/test_torch_*.py`` files import the ``reference`` fixture
and the converters from here. Arrays cross between the frameworks as numpy
(bf16 as ``uint16`` views, as ``repro.checkpoint`` stores it).
"""
import ast
import contextlib
import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import base as port_base
from repro_torch.configs import get_arch as port_get_arch
from repro_torch.convert import params_from_jax
from repro_torch.data import tokens as port_tokens


def apply_jax_fix():
    """Let ``key in batching.primitive_batchers`` work under jax 0.9.
    Idempotent; returns whether this call added the fix."""
    from jax.interpreters import batching
    proxy = type(batching.primitive_batchers)
    if "__contains__" in vars(proxy):
        return False
    proxy.__contains__ = (
        lambda self, key: key in batching.fancy_primitive_batchers)
    return True


def remove_jax_fix():
    """Undo ``apply_jax_fix``."""
    from jax.interpreters import batching
    del type(batching.primitive_batchers).__contains__


def _reference_module_names():
    return {n for n in sys.modules if n == "repro" or n.startswith("repro.")}


@contextlib.contextmanager
def reference_modules():
    """The JAX reference's modules, imported after the jax 0.9 fix. On
    exit the process is left as it was found: the fix is undone if this
    call applied it, and the reference modules first imported here are
    forgotten. Otherwise a reference test that imports ``repro.core``
    inside its body would pass or fail depending on whether a port test
    ran before it in the same worker."""
    before = _reference_module_names()
    added = apply_jax_fix()
    try:
        yield _import_reference()
    finally:
        if added:
            remove_jax_fix()
        for name in _reference_module_names() - before:
            module = sys.modules.pop(name)
            parent, _, child = name.rpartition(".")
            if getattr(sys.modules.get(parent), child, None) is module:
                delattr(sys.modules[parent], child)


@pytest.fixture(scope="module")
def reference():
    """The JAX reference's modules, for one test module
    (``reference_modules``)."""
    with reference_modules() as modules:
        yield modules


def _import_reference():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.core import (gal, gal_lm, losses, membership, organizations,
                            privacy, protocol_sim, weights)
    from repro.data import partition, synthetic, tokens
    from repro.kernels import ref
    from repro.kernels.flash_attention import flash_attention_kernel
    from repro.kernels.residual_xent import residual_xent_kernel
    from repro.metrics import metrics
    from repro.models import attention, layers, transformer, zoo
    from repro.optim import lbfgs, optimizers
    from repro.train import steps
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_arch=get_arch, gal_lm=gal_lm, losses=losses,
        weights=weights, tokens=tokens, ref=ref,
        residual_xent_kernel=residual_xent_kernel,
        flash_attention_kernel=flash_attention_kernel, attention=attention,
        layers=layers, tfm=transformer, lbfgs=lbfgs, optimizers=optimizers,
        steps=steps, gal=gal, organizations=organizations, privacy=privacy,
        protocol_sim=protocol_sim, membership=membership,
        synthetic=synthetic, partition=partition, metrics=metrics, zoo=zoo)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers at once; one torch thread each keeps
    them off each other's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------ converters
def jax_to_numpy(tree):
    """A jax tree as numpy leaves, bf16 as uint16 views."""
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def torch_to_numpy(tree):
    """A torch tree as numpy leaves, bf16 as uint16 views."""
    if isinstance(tree, dict):
        return {k: torch_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def jax_tree_to_torch(tree, device="cpu"):
    """A jax tree of dicts and lists as the same tree of torch tensors."""
    if isinstance(tree, dict):
        return {k: jax_tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(jax_tree_to_torch(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype == np.int32:            # StumpBoost's feature indices
        arr = arr.astype(np.int64)
    return torch.from_numpy(arr.copy()).to(device)


def reference_model(reference, model):
    """The reference zoo model of the port model's class and fields."""
    cls = getattr(reference.zoo, type(model).__name__)
    return cls(**dataclasses.asdict(model))


class ReferenceDraws:
    """The draws of the port's ``gal.fit`` (``repro_torch.core.gal.Draws``)
    replayed from the reference's own key chain: round t's key is the
    second half of the t-th ``jax.random.split`` of ``key``, as the
    reference's ``_fit_python`` takes it, and each draw is folded in from
    it as the reference folds it. Values cross as numpy."""

    def __init__(self, reference, key):
        self.ref = reference
        self._key = key
        self._rounds = []

    def k_round(self, t):
        jax = self.ref.jax
        while len(self._rounds) <= t:
            self._key, k = jax.random.split(self._key)
            self._rounds.append(k)
        return self._rounds[t]

    def init_params(self, t, org, x, k):
        jax, jnp = self.ref.jax, self.ref.jnp
        params = reference_model(self.ref, org.model).init(
            jax.random.fold_in(self.k_round(t), org.index),
            jnp.zeros((1, x.shape[-1]), jnp.float32), k)
        return jax_tree_to_torch(params, x.device)

    def theta0(self, t, org_ids):
        jax, jnp = self.ref.jax, self.ref.jnp
        rng = jax.random.fold_in(self.k_round(t), 29)
        keys = jax.vmap(lambda i: jax.random.fold_in(rng, i))(
            jnp.asarray(org_ids, jnp.uint32))
        theta = np.asarray(0.01 * jax.vmap(
            lambda kk: jax.random.normal(kk, (), jnp.float32))(keys))
        return {i: torch.tensor(theta[j]) for j, i in enumerate(org_ids)}

    def privacy_u(self, t, shape):
        jax = self.ref.jax
        return torch.from_numpy(np.asarray(jax.random.uniform(
            jax.random.fold_in(self.k_round(t), 13), tuple(shape))).copy())


def port_cfg(cfg):
    """The port's ModelConfig with the reference config's fields."""
    return port_base.ModelConfig(**dataclasses.asdict(cfg))


def port_params(jax_params, cfg):
    return params_from_jax(jax_to_numpy(jax_params), port_cfg(cfg), "cpu")


def assert_trees_close(got, want, atol, rtol=0.0):
    """got: torch tree; want: jax tree; compared in f32."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_trees_close(got[k], want[k], atol, rtol)
        return
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


# ----------------------------------------------------------------- tests
def test_reference_modules_leave_no_trace():
    """Entering and leaving ``reference_modules`` leaves the fix and the
    imported reference modules as they were: the reference's own tests
    see the same process whether or not a port test ran first."""
    from jax.interpreters import batching
    proxy = type(batching.primitive_batchers)
    had_fix = "__contains__" in vars(proxy)
    before = _reference_module_names()
    with reference_modules() as ref:
        assert ref.gal_lm.fit_lm is not None
        assert "repro.core.gal_lm" in sys.modules
    assert ("__contains__" in vars(proxy)) == had_fix
    assert _reference_module_names() == before
    if not had_fix:
        assert "repro.core.gal_lm" not in sys.modules


def test_jax_fix_makes_reference_importable(reference):
    from jax._src.lax.lax import optimization_barrier_p
    from jax.interpreters import batching
    # the lookup the reference makes at import now answers
    assert optimization_barrier_p in batching.primitive_batchers
    assert reference.gal_lm.fit_lm is not None
    apply_jax_fix()                                   # idempotent
    assert optimization_barrier_p in batching.primitive_batchers


def test_jax_fix_leaves_reference_source_untouched():
    """The fix lives here, in the test harness: no file of the reference
    mentions it, and this module applies it only from a function."""
    import repro.models
    from pathlib import Path
    src = Path(repro.models.__file__).parent / "transformer.py"
    assert "fancy_primitive_batchers" not in src.read_text()
    tree = ast.parse(Path(__file__).read_text())
    top_calls = [n for n in tree.body if isinstance(n, ast.Expr)
                 and isinstance(n.value, ast.Call)]
    assert not top_calls, "no call may run at import"


def test_configs_field_for_field(reference):
    ref_fields = [(f.name, f.type, f.default) for f in
                  dataclasses.fields(reference.get_arch("llama3-8b"))]
    got_fields = [(f.name, f.type, f.default) for f in
                  dataclasses.fields(port_base.ModelConfig)]
    assert got_fields == ref_fields
    for smoke in (False, True):
        want = reference.get_arch("llama3-8b", smoke=smoke)
        got = port_get_arch("llama3-8b", smoke=smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.hd == want.hd


@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-1.7b",
                                  "stablelm-1.6b"])
def test_dense_configs_field_for_field(reference, arch):
    """The other dense configs, full and smoke, as the reference has
    them."""
    for smoke in (False, True):
        want = reference.get_arch(arch, smoke=smoke)
        got = port_get_arch(arch, smoke=smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.hd == want.hd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_is_one_to_one(reference, dtype):
    cfg = dataclasses.replace(reference.get_arch("llama3-8b", smoke=True),
                              dtype=dtype)
    jp = reference.tfm.init_params(reference.jax.random.PRNGKey(3), cfg)
    got = port_params(jp, cfg)
    want = jax_to_numpy(jp)
    back = torch_to_numpy(got)

    def check(g, w, b):
        if isinstance(w, dict):
            assert list(g) == list(w)
            for k in w:
                check(g[k], w[k], b[k])
            return
        assert tuple(g.shape) == w.shape
        assert b.dtype == w.dtype
        np.testing.assert_array_equal(b, w)           # bitwise

    check(got, want, back)
    assert got["embed"]["tok"].dtype == getattr(torch, dtype)
    assert got["layers"]["ln1"]["scale"].dtype == torch.float32


def test_params_from_jax_rejects_other_config(reference):
    cfg = reference.get_arch("llama3-8b", smoke=True)
    np_tree = jax_to_numpy(
        reference.tfm.init_params(reference.jax.random.PRNGKey(0), cfg))
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(np_tree, port_cfg(
            dataclasses.replace(cfg, n_layers=3)), "cpu")
    with pytest.raises(ValueError, match="vocab"):
        params_from_jax(np_tree, port_cfg(
            dataclasses.replace(cfg, vocab=1024)), "cpu")


def test_token_stream_and_batches_bitwise(reference):
    want_s = reference.tokens.make_token_stream(
        np.random.default_rng(7), 1024, 5000)
    got_s = port_tokens.make_token_stream(np.random.default_rng(7), 1024,
                                          5000)
    np.testing.assert_array_equal(got_s, want_s)
    want = reference.tokens.token_batches(want_s, 4, 32,
                                          np.random.default_rng(1))
    got = port_tokens.token_batches(got_s, 4, 32, np.random.default_rng(1))
    for _ in range(3):
        (wt, wl), (gt, gl) = next(want), next(got)
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gl, wl)
