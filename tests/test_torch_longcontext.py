"""The port's long-context training script (``tpu_syncbn_torch.longcontext_train``)
against ``examples/longcontext_train.py`` at one device: the same batches,
and three Adam steps of the flash-kernel path (``--impl ulysses
--local-impl flash --local-backward pallas``) against a JAX step with the
same math — ``value_and_grad`` of the token-mean cross-entropy of
``transformer_lm(attn_impl="flash_pallas_bwd")`` and ``optax.adam`` — from
the same parameters, in float32.

Tolerance: rtol 1e-5 / atol 1e-4 on the loss and every parameter. Adam
divides each gradient by its own running RMS, so after three steps a
parameter moves by about 3·lr = 9e-3 whatever its gradient's size; f32
rounding of the gradients (1e-6 relative) moves that by far less than 1e-4.
"""

import ast
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_syncbn.models import transformer as tfm
from tpu_syncbn_torch import longcontext_train as lct
from tpu_syncbn_torch.models import TransformerLM, load_jax_transformer_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def example_sampler(args):
    """``sample_batch`` and its RandomState exactly as the example's source
    defines them (``examples/longcontext_train.py``), executed here."""
    path = os.path.join(ROOT, "examples", "longcontext_train.py")
    tree = ast.parse(open(path).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "main")
    keep = [n for n in main.body
            if (isinstance(n, ast.FunctionDef) and n.name == "sample_batch")
            or (isinstance(n, ast.Assign) and ast.unparse(n.targets[0]) == "rng")]
    assert len(keep) == 2
    ns = {"np": np, "args": args, "L": args.L}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    return ns["sample_batch"]


@pytest.mark.parametrize("seed,batch,length,vocab", [(0, 4, 64, 32), (7, 3, 100, 50)])
def test_sampler_is_bit_identical_to_the_example(seed, batch, length, vocab):
    args = types.SimpleNamespace(seed=seed, batch=batch, vocab=vocab, L=length)
    want = example_sampler(args)
    got = lct.periodic_batches(seed, batch, length, vocab)
    for _ in range(5):
        a, b = next(got), want()
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)


def test_flags_map_to_the_one_device_attention():
    assert lct.attn_impl("ring", "oracle", "xla") is None
    assert lct.attn_impl("ulysses", "oracle", "xla") is None
    assert lct.attn_impl("ulysses", "flash", "xla") == "flash"
    assert lct.attn_impl("ulysses", "flash", "pallas") == "flash_pallas_bwd"
    with pytest.raises(SystemExit, match="apply to --impl ulysses only"):
        lct.attn_impl("ring", "flash", "xla")
    args = lct.parse_args([])
    assert (args.impl, args.local_impl, args.local_backward, args.steps,
            args.batch, args.seq_per_device, args.d_model, args.d_ff,
            args.n_heads, args.n_layers, args.vocab, args.lr, args.seed,
            args.device) == ("ring", "oracle", "xla", 60, 4, 64, 64, 128, 8,
                             2, 32, 3e-3, 0, "cuda")


def test_three_adam_steps_match_the_jax_step():
    args = lct.parse_args(["--impl", "ulysses", "--local-impl", "flash",
                           "--local-backward", "pallas", "--device", "cpu"])
    L = args.seq_per_device
    cfg = dict(vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
               n_layers=args.n_layers, d_ff=args.d_ff, max_len=L)
    params = tfm.init_transformer_lm(jax.random.PRNGKey(args.seed), **cfg)
    opt = optax.adam(args.lr)
    opt_state = opt.init(params)

    def loss_fn(p, inputs, labels):
        logits = tfm.transformer_lm(p, inputs, n_heads=args.n_heads,
                                    attn_impl="flash_pallas_bwd")
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        return jnp.sum(ce) / (args.batch * L)

    model = TransformerLM(**cfg, device="cpu")
    load_jax_transformer_params(model, jax.tree.map(np.asarray, params))
    topt = torch.optim.Adam(model.parameters(), lr=args.lr)
    impl = lct.attn_impl(args.impl, args.local_impl, args.local_backward)
    batches = lct.periodic_batches(args.seed, args.batch, L, args.vocab)
    for _ in range(3):
        toks = next(batches)
        loss_j, grads = jax.value_and_grad(loss_fn)(
            params, jnp.asarray(toks[:, :L]), jnp.asarray(toks[:, 1:]))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        t = torch.from_numpy(toks)
        loss_t = lct.train_step(model, topt, t[:, :L], t[:, 1:], attn_impl=impl)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5, atol=1e-4)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        want[".".join(k.key for k in path)] = np.asarray(leaf)
    assert set(want) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-5,
                                   atol=1e-4, err_msg=name)


def test_cpu_recipe_trains():
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-m", "tpu_syncbn_torch.longcontext_train",
         "--device", "cpu", "--steps", "30"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    losses = [float(line.split()[-1]) for line in r.stdout.splitlines()
              if line.startswith("step")]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert "done: ring over 1 seq shard, global L=64" in r.stdout
