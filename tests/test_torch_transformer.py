"""The port's transformer LM (``tpu_syncbn_torch.models.transformer``)
against the JAX package's ``transformer_lm``: the same parameters (copied
by ``load_jax_transformer_params``) and tokens give the same logits and
gradients for each single-device attention impl, in float32, and for the
sequence-parallel impls at a group of one against JAX's LM on a mesh of one.
The JAX flash kernels run in interpret mode on the CPU, as its own tests
run them. The sequence-parallel impls across ranks are held against JAX in
``tests/test_torch_longcontext.py`` (the LM at world 2) and
``tests/test_torch_sequence.py``.

Tolerance: rtol 1e-5 / atol 3e-4, as ``tests/test_transformer.py`` holds
the JAX LM's attention impls against each other (f32 sums in another
order through two layers, a vocab-wide head and the backward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_syncbn.models import transformer as tfm
from tpu_syncbn_torch.models import (
    TransformerLM,
    init_transformer_lm,
    load_jax_transformer_params,
)
from tpu_syncbn_torch.parallel.collectives import ALONE

CFG = dict(vocab=37, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=64)
B, L = 2, 48  # L < max_len: the positions are sliced
TOL = dict(rtol=1e-5, atol=3e-4)


def flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


@pytest.fixture(scope="module")
def jax_params():
    return tfm.init_transformer_lm(jax.random.PRNGKey(3), **CFG)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, CFG["vocab"], (B, L)).astype(np.int32)


def port_model(params):
    model = TransformerLM(**CFG, device="cpu")
    load_jax_transformer_params(model, jax.tree.map(np.asarray, params))
    return model


def test_init_has_the_jax_keys_shapes_and_distributions(jax_params):
    want = {k: v.shape for k, v in flat(jax_params).items()}
    model = init_transformer_lm(0, **CFG, device="cpu")
    got = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert got == want
    p = dict(model.named_parameters())
    for name in ("blocks.ln1_scale", "blocks.ln2_scale", "ln_f_scale"):
        assert torch.equal(p[name], torch.ones_like(p[name]))
    assert abs(float(p["embed"].detach().std()) - 0.02) < 0.002
    assert abs(float(p["blocks.w2"].detach().std()) - CFG["d_ff"] ** -0.5) < 0.01
    again = init_transformer_lm(0, **CFG, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))


@pytest.mark.parametrize("impl", [None, "flash", "flash_pallas_bwd"])
def test_logits_match_the_jax_lm(jax_params, tokens, impl):
    want = tfm.transformer_lm(jax_params, jnp.asarray(tokens),
                              n_heads=CFG["n_heads"], attn_impl=impl)
    with torch.no_grad():
        got = port_model(jax_params)(torch.from_numpy(tokens), attn_impl=impl)
    assert got.dtype == torch.float32 and got.shape == (B, L, CFG["vocab"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", [None, "flash", "flash_pallas_bwd"])
def test_gradients_match_jax_grad(jax_params, tokens, impl):
    w = np.random.default_rng(1).standard_normal((B, L, CFG["vocab"])).astype(np.float32)

    def loss(p):
        logits = tfm.transformer_lm(p, jnp.asarray(tokens),
                                    n_heads=CFG["n_heads"], attn_impl=impl)
        return jnp.sum(jnp.tanh(logits) * w)

    want = flat(jax.grad(loss)(jax_params))
    model = port_model(jax_params)
    logits = model(torch.from_numpy(tokens), attn_impl=impl)
    (torch.tanh(logits) * torch.from_numpy(w)).sum().backward()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], err_msg=name, **TOL)


def test_a_sequence_longer_than_max_len_raises():
    model = init_transformer_lm(0, **CFG, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len 64"):
        model(torch.zeros(1, 65, dtype=torch.long))


@pytest.mark.parametrize("kw,match", [
    (dict(attn_impl="dense"), "unknown attention impl"),
    (dict(attn_impl="ring_zigzag", group=ALONE), "ring_zigzag is not supported at the LM"),
    (dict(attn_impl="flash", group=ALONE), "dense single-device kernel"),
    (dict(attn_impl="ring", group=ALONE, local_impl="flash"), "apply to attn_impl='ulysses'"),
    (dict(attn_impl="ulysses", local_impl="flash"), "apply to attn_impl='ulysses' with a"),
    (dict(attn_impl="ulysses", group=ALONE, local_backward="pallas"),
     "local_backward applies to local_impl='flash'"),
])
def test_attention_arguments_are_checked_as_jax_checks_them(kw, match):
    model = init_transformer_lm(0, **CFG, device="cpu")
    with pytest.raises(ValueError, match=match):
        model(torch.zeros(1, 8, dtype=torch.long), **kw)


SEQ_IMPLS = {
    "ring": dict(attn_impl="ring"),
    "ulysses": dict(attn_impl="ulysses"),
    "ulysses+flash": dict(attn_impl="ulysses", local_impl="flash"),
    "ulysses+flash+pallas": dict(attn_impl="ulysses", local_impl="flash",
                                 local_backward="pallas"),
}


@pytest.mark.parametrize("name", list(SEQ_IMPLS))
def test_sequence_impls_at_world_one_match_the_jax_lm(jax_params, tokens, name):
    """A group of one (ALONE) against JAX's LM under shard_map on a mesh of
    one ``seq`` device: logits and gradients."""
    from jax.sharding import Mesh, PartitionSpec as P

    from tpu_syncbn.compat import shard_map

    kw = SEQ_IMPLS[name]
    w = np.random.default_rng(2).standard_normal((B, L, CFG["vocab"])).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("seq",))
    lm = shard_map(lambda p, t: tfm.transformer_lm(p, t, n_heads=CFG["n_heads"],
                                                   axis_name="seq", **kw),
                   mesh=mesh, in_specs=(P(), P(None, "seq")), out_specs=P(None, "seq"),
                   check_vma="local_impl" not in kw)

    def loss(p):
        return jnp.sum(jnp.tanh(lm(p, jnp.asarray(tokens))) * w)

    want_logits = jax.jit(lm)(jax_params, jnp.asarray(tokens))
    want = flat(jax.jit(jax.grad(loss))(jax_params))
    model = port_model(jax_params)
    logits = model(torch.from_numpy(tokens), group=ALONE, **kw)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), **TOL)
    (torch.tanh(logits) * torch.from_numpy(w)).sum().backward()
    for pname, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[pname], err_msg=pname, **TOL)


@pytest.mark.parametrize("offset", [0, 9, CFG["max_len"] - 20])
def test_an_explicit_position_offset_matches_the_jax_lm(jax_params, offset):
    """``pos_offset``: the chunk's first global position (JAX's
    ``dynamic_slice`` start); one past ``max_len`` raises instead of
    clamping."""
    toks = np.random.default_rng(4).integers(0, CFG["vocab"], (B, 20)).astype(np.int32)
    want = tfm.transformer_lm(jax_params, jnp.asarray(toks), n_heads=CFG["n_heads"],
                              pos_offset=jnp.int32(offset))
    with torch.no_grad():
        got = port_model(jax_params)(torch.from_numpy(toks), pos_offset=offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="exceed max_len"):
        port_model(jax_params)(torch.from_numpy(toks), pos_offset=offset + 45)


def test_the_loader_pairs_every_name(jax_params):
    params = jax.tree.map(np.asarray, jax_params)
    model = TransformerLM(**CFG, device="cpu")
    extra = dict(params, head=np.zeros(3))
    with pytest.raises(KeyError, match="JAX only \\['head'\\]"):
        load_jax_transformer_params(model, extra)
    short = {k: v for k, v in params.items() if k != "pos"}
    with pytest.raises(KeyError, match="port only \\['pos'\\]"):
        load_jax_transformer_params(model, short)
    bad = dict(params, ln_f_scale=np.ones(5))
    with pytest.raises(ValueError, match="ln_f_scale"):
        load_jax_transformer_params(model, bad)


def test_bf16_model_runs_in_bf16():
    model = init_transformer_lm(0, **CFG, dtype=torch.bfloat16, device="cpu")
    logits = model(torch.zeros(2, 16, dtype=torch.long), attn_impl="flash_pallas_bwd")
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
