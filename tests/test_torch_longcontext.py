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
from tpu_syncbn_torch.parallel.collectives import ALONE

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
    """The flags become the LM's attention arguments; at one process the
    group is ALONE, where ring is the dense attention and Ulysses its local
    attention (the flash kernels with --local-impl flash)."""
    assert lct.attention_kwargs("ring", "oracle", "xla") == dict(attn_impl="ring")
    assert lct.attention_kwargs("ulysses", "oracle", "xla") == dict(attn_impl="ulysses")
    assert lct.attention_kwargs("ulysses", "oracle", "pallas") == dict(attn_impl="ulysses")
    assert lct.attention_kwargs("ulysses", "flash", "xla") == dict(
        attn_impl="ulysses", local_impl="flash", local_backward="xla")
    assert lct.attention_kwargs("ulysses", "flash", "pallas") == dict(
        attn_impl="ulysses", local_impl="flash", local_backward="pallas")
    with pytest.raises(SystemExit, match="apply to --impl ulysses only"):
        lct.attention_kwargs("ring", "flash", "xla")
    args = lct.parse_args([])
    assert (args.impl, args.local_impl, args.local_backward, args.steps,
            args.batch, args.seq_per_device, args.d_model, args.d_ff,
            args.n_heads, args.n_layers, args.vocab, args.lr, args.seed,
            args.device, args.simulate) == ("ring", "oracle", "xla", 60, 4, 64, 64, 128,
                                             8, 2, 32, 3e-3, 0, "cuda", 0)
    with pytest.raises(SystemExit, match="pass --device cpu"):
        lct.main(["--simulate", "2"])


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
    attn = lct.attention_kwargs(args.impl, args.local_impl, args.local_backward)
    batches = lct.periodic_batches(args.seed, args.batch, L, args.vocab)
    for _ in range(3):
        toks = next(batches)
        loss_j, grads = jax.value_and_grad(loss_fn)(
            params, jnp.asarray(toks[:, :L]), jnp.asarray(toks[:, 1:]))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        t = torch.from_numpy(toks)
        loss_t = lct.train_step(model, topt, t[:, :L], t[:, 1:], group=ALONE, **attn)
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


# -- world 2: the sequence sharded across two gloo processes ---------------------

WORLD2_CASES = {
    "ring": ["--impl", "ring"],
    "ulysses+flash+pallas": ["--impl", "ulysses", "--local-impl", "flash",
                             "--local-backward", "pallas"],
}
WORLD2_STEPS = 3


def _lm_replica(rank, world, rdv, out_dir, params, batches):
    """One of the world-2 processes: every case's three steps on this rank's
    chunk of the same global batches, from the same parameters."""
    import torch.distributed as tdist

    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world,
                             rank=rank)
    try:
        out = {}
        args = lct.parse_args(["--device", "cpu"])
        for name, flags in WORLD2_CASES.items():
            a = lct.parse_args(flags + ["--device", "cpu"])
            attn = lct.attention_kwargs(a.impl, a.local_impl, a.local_backward)
            model = TransformerLM(vocab=args.vocab, d_model=args.d_model,
                                  n_heads=args.n_heads, n_layers=args.n_layers,
                                  d_ff=args.d_ff, max_len=world * args.seq_per_device,
                                  device="cpu")
            load_jax_transformer_params(model, params)
            opt = torch.optim.Adam(model.parameters(), lr=args.lr)
            losses = []
            for i, toks in enumerate(batches):
                inputs, labels = (torch.from_numpy(x) for x in
                                  lct.local_chunk(toks, rank, args.seq_per_device))
                losses.append(float(lct.train_step(model, opt, inputs, labels,
                                                   group=tdist.group.WORLD, **attn)))
                if i == 0:  # the step's summed gradients stay in .grad
                    for pname, p in model.named_parameters():
                        out[f"{name}.grad.{pname}"] = p.grad.numpy().copy()
            out[f"{name}.loss"] = np.asarray(losses)
            for pname, p in model.named_parameters():
                out[f"{name}.{pname}"] = p.detach().numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        tdist.destroy_process_group()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The JAX parameters, the batches, and each rank's results."""
    import time

    import torch.multiprocessing as tmp

    args = lct.parse_args([])
    L = 2 * args.seq_per_device
    params = jax.tree.map(np.asarray, tfm.init_transformer_lm(
        jax.random.PRNGKey(args.seed), vocab=args.vocab, d_model=args.d_model,
        n_heads=args.n_heads, n_layers=args.n_layers, d_ff=args.d_ff, max_len=L))
    stream = lct.periodic_batches(args.seed, args.batch, L, args.vocab)
    batches = [next(stream) for _ in range(WORLD2_STEPS)]
    d = tmp_path_factory.mktemp("lm2")
    procs = [tmp.get_context("spawn").Process(
        target=_lm_replica, args=(r, 2, str(d / "rdv"), str(d), params, batches))
        for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 240
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(5)
    assert not alive and [p.exitcode for p in procs] == [0, 0]
    return params, batches, [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]


def _leaves(tree) -> dict:
    return {".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_example_steps(params, batches, flags):
    """The example's ``step_body`` under shard_map on a mesh of two ``seq``
    devices (the global token-mean loss as a psum of local sums, the
    gradients' psum, ``optax.adam``): the losses, step 1's summed
    gradients and the parameters after the steps."""
    from jax.sharding import Mesh, PartitionSpec as P

    from tpu_syncbn.compat import shard_map
    from tpu_syncbn.parallel import collectives

    args = lct.parse_args(flags)
    flash = args.impl == "ulysses" and args.local_impl == "flash"
    total = args.batch * 2 * args.seq_per_device
    opt = optax.adam(args.lr)

    def step_body(p, opt_state, inputs, labels):
        def loss_fn(p_in):
            logits = tfm.transformer_lm(
                p_in, inputs, n_heads=args.n_heads, attn_impl=args.impl,
                axis_name="seq",
                **({"local_impl": "flash", "local_backward": args.local_backward}
                   if flash else {}))
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
            return collectives.psum(jnp.sum(ce), "seq") / total

        loss, grads = jax.value_and_grad(loss_fn)(collectives.pcast_varying(p, "seq"))
        grads = collectives.psum(grads, "seq")
        updates, opt_state = opt.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss, grads

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("seq",))
    step = jax.jit(shard_map(step_body, mesh=mesh,
                             in_specs=(P(), P(), P(None, "seq"), P(None, "seq")),
                             out_specs=(P(), P(), P(), P()), check_vma=not flash))
    p, opt_state, losses, grads = params, opt.init(params), [], None
    for toks in batches:
        L = toks.shape[1] - 1
        p, opt_state, loss, g = step(p, opt_state, jnp.asarray(toks[:, :L]),
                                     jnp.asarray(toks[:, 1:]))
        losses.append(float(loss))
        grads = grads or _leaves(g)
    return losses, grads, _leaves(p)


@pytest.mark.parametrize("name", list(WORLD2_CASES))
def test_three_adam_steps_at_world_two_match_the_jax_example(world2, name):
    """Each rank holds its contiguous half of every sequence. Against the
    example's sharded step from the same parameters and batches:

    * the losses of the three steps, rtol 1e-5 / atol 1e-4 (as at world 1);
    * step 1's summed gradients, rtol 1e-5 / atol 1e-5 of the tensor's
      largest: f32 sums of B·L = 512 token terms in another order round
      apart by ~L·2^-24 of their largest term. With the flash kernels the
      example's shard_map runs without the VMA checker (Pallas interpret
      mode), where the loss's psum transposes to a psum: its gradients are
      exactly world × the gradient (Adam's update does not see the scale),
      so they are divided by the world first;
    * both ranks' parameters bit for bit after three steps;
    * the parameters after three steps, rtol 1e-5 / atol 1e-4, wherever
      step 1's gradient is above 1e-4 of its tensor's largest. Below that
      its sign and size are rounding (measured: elements at 1e-8 to 1e-7 of
      a 1e-2 maximum), and Adam's normalized update moves them by up to lr
      either way: by Cauchy-Schwarz |m̂/√v̂| <= 1.004 at step 3 (β1 0.9, β2
      0.999), so there they agree within 2 · 3 · 1.004 · lr.
    """
    params, batches, ranks = world2
    losses, grads, want = _jax_example_steps(params, batches, WORLD2_CASES[name])
    lr = lct.parse_args([]).lr
    for r in ranks:
        np.testing.assert_allclose(r[f"{name}.loss"], losses, rtol=1e-5, atol=1e-4)
    scale = 2 if "flash" in name else 1
    for pname, value in want.items():
        g = grads[pname] / scale
        np.testing.assert_allclose(ranks[0][f"{name}.grad.{pname}"], g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max(), err_msg=pname)
        got = ranks[0][f"{name}.{pname}"]
        np.testing.assert_array_equal(got, ranks[1][f"{name}.{pname}"])
        settled = np.abs(g) > 1e-4 * np.abs(g).max()
        np.testing.assert_allclose(got[settled], value[settled], rtol=1e-5, atol=1e-4,
                                   err_msg=pname)
        assert (np.abs(got - value) <= 6 * 1.004 * lr).all(), pname


def test_simulated_world_two_trains():
    """``--simulate 2 --device cpu``: two gloo processes under the port's
    launcher, the loss falls."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-m", "tpu_syncbn_torch.longcontext_train", "--simulate", "2",
         "--device", "cpu", "--steps", "12", "--impl", "ulysses"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    losses = [float(line.split()[-1]) for line in r.stdout.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert "done: ulysses+oracle over 2 seq shards, global L=128" in r.stdout
