"""Data-parallel GAN trainer — the counterpart of
``tpu_syncbn.parallel.gan_trainer``: alternating D and G updates with
SyncBN in both networks, the reference's GAN capability case (BASELINE
config 5), where tiny per-GPU batches make per-replica BN statistics
destabilize training.

One iteration is one D update, then one G update, with the torch DCGAN
loop's ordering of the running-statistic updates:

* D step: ``fake = G(z_d)`` runs G in **train mode without a gradient**
  (``torch.no_grad()``, never ``eval()``), so G's BN statistics move; D
  sees ``real`` and ``fake`` as two forwards, so D's move twice. Only D's
  gradients are taken, then averaged over the group, then D steps.
* G step: ``D(G(z_g))``, D with its just-updated weights; G's and D's
  statistics move once more. Only G's gradients are taken
  (``backward(inputs=G's parameters)``, as the JAX step differentiates
  with respect to G's parameters only), so no gradient lands in D's
  ``.grad`` for the next D update.

Per iteration G's BN layers move ``num_batches_tracked`` by 2 and D's by
3; each of G's 4 BN layers runs its forward kernels twice and its
backward kernels once, each of D's 2 runs its forward kernels three times
and its backward kernels twice (14 and 10 launches of each kernel an
iteration at the DCGAN widths). ``d_loss``, ``g_loss``, ``d_real`` and
``d_fake`` are replica-averaged in one all-reduce, and both networks'
buffers (BN statistics and SNConv's ``u``) are broadcast from rank 0 at
the end, as the JAX step does.

``train_steps`` runs K iterations as one program (one CUDA graph on
the card). ``compress`` puts both networks' gradient mean on a compressed
wire (``collectives.compressed_pmean``, at every world size), stateless:
error feedback is a ``DataParallel`` feature, as in the JAX package.
Losses, metrics and the buffer broadcast stay exact.

``monitors`` (default ``True``, as in the JAX trainer) returns the
iteration's health scalars as device tensors in ``GANStepOutput.monitors``:
``d_grad_norm``/``d_grad_nonfinite`` and ``g_*`` over each network's
averaged gradients, the BN running-statistic health over both networks'
buffers (``obs.stepstats.state_health``; per-layer keys under ``"full"``,
G's prefixed ``.0``, D's ``.1``, as the JAX tuple path names them), and
the numerics family through one all-reduce: the BN skew of both sub-steps
(the worse wins), ``d_``/``g_replica_grad_norm`` with their dispersions,
and the int8 wire's ``clip_fraction``/``overflow_headroom``.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import time
from typing import Callable

import torch
from torch import nn

from tpu_syncbn_torch.obs import flightrec
from tpu_syncbn_torch.obs import numerics as obs_numerics, stepstats as obs_stepstats
from tpu_syncbn_torch.parallel import collectives, scan_driver
from tpu_syncbn_torch.parallel.trainer import (
    _check_capturable,
    _ChunkOptimizer,
    _default_group,
    _grads_for_all_reduce,
    _load_named_state_,
    _named_state,
    _rewire_syncbn_groups,
    _schedule_lrs,
    _to_device,
    check_monitors,
    sync_module_states,
)
from tpu_syncbn_torch.runtime.distributed import resolve_device

LOSSES = ("bce", "hinge")


def loss_pair(name: str) -> Callable:
    """The ``(real_logits, fake_logits) -> (d_loss, g_loss)`` function of a
    loss name (imported here: ``models`` imports the BN ops, which import
    this package)."""
    from tpu_syncbn_torch.models.gan import bce_gan_losses, hinge_gan_losses

    return {"bce": bce_gan_losses, "hinge": hinge_gan_losses}[name]


@dataclasses.dataclass
class GANStepOutput:
    """What an iteration returns: replica-averaged losses and metrics, and
    the monitors (``{}`` with monitors off), as device tensors (reading a
    value waits for the iteration)."""

    d_loss: torch.Tensor
    g_loss: torch.Tensor
    metrics: dict[str, torch.Tensor]
    monitors: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


class GANTrainer:
    """Two-network, two-optimizer data-parallel trainer.

    ``train_step(real, z_d, z_g)`` takes this replica's shard of the real
    batch and of two latent batches (one per sub-step: the torch loop draws
    fresh noise for the G step) and performs one D update, then one G
    update. The optimizers are ``torch.optim`` optimizers over each
    network's parameters (``optax.adam(lr, b1=0.5, b2=0.999)`` is
    ``torch.optim.Adam(params, lr, betas=(0.5, 0.999))``).

    ``group`` is the process group to average over (``None``: the default
    world group). ``layout`` (a :class:`~tpu_syncbn_torch.parallel.layout.SpecLayout`
    with replicated parameters, e.g. ``SpecLayout({"data": 2, "fsdp": 2},
    param_shard_axis=None)``) replaces it: its composed batch group is the
    statistics' and the gradients' group, and both networks' default-group
    SyncBN layers are rewired to it; a layout with a ``param_shard_axis``
    raises (GAN state stays replicated), and so do ``group`` and
    ``layout`` together. ``compress`` (``"none"``, ``"bf16"`` or ``"int8"``) is
    the wire of both networks' gradient mean: each network's gradients
    fused in ``named_parameters()`` order, no error feedback (prefer
    ``"bf16"`` for GANs). ``monitors`` (``True``, ``False`` or ``"full"``)
    is the module docstring's; any other value raises ``ValueError``. Both
    models must already be on ``device`` (default ``"cuda"``, which raises
    without a card); their parameters and buffers are broadcast from rank
    0 at construction."""

    def __init__(
        self,
        generator: nn.Module,
        discriminator: nn.Module,
        g_optimizer: torch.optim.Optimizer,
        d_optimizer: torch.optim.Optimizer,
        *,
        loss: str = "bce",
        group=None,
        layout=None,
        monitors: bool | str = True,
        compress: str = "none",
        device: str | torch.device | None = "cuda",
    ):
        if loss not in LOSSES:
            raise ValueError(f"loss must be one of {LOSSES}, got {loss!r}")
        check_monitors(monitors)
        self.monitors = monitors
        self.compress = collectives.check_compress_mode(compress)
        self.device = resolve_device(device)
        for net, model in (("generator", generator), ("discriminator", discriminator)):
            for name, t in list(model.named_parameters()) + list(model.named_buffers()):
                if t is not None and t.device != self.device:
                    raise ValueError(
                        f"{net} {name} lives on {t.device}, not on the "
                        f"trainer's device {self.device}; move the model first")
        self.generator = generator
        self.discriminator = discriminator
        self.g_optimizer = g_optimizer
        self.d_optimizer = d_optimizer
        self.loss = loss
        self.loss_pair = loss_pair(loss)
        self.layout = layout
        if layout is not None:
            if group is not None:
                raise ValueError("pass either layout= or group=, not both — the "
                                 "layout owns the groups")
            if layout.param_shard_axis is not None:
                raise ValueError(
                    "GANTrainer keeps params replicated — use a layout "
                    "without a param shard axis"
                )
            layout.check(compress=compress)
            group = layout.batch_group()
            if isinstance(layout.stat_axes, tuple):
                _rewire_syncbn_groups(generator, group)
                _rewire_syncbn_groups(discriminator, group)
        self.group = group if group is not None else _default_group()
        self.world = collectives.world_size(self.group)
        #: iterations taken (one D and one G update each)
        self.step_count = 0
        for model in (generator, discriminator):
            sync_module_states(model, group=self.group)
        # (K, batch signature) -> captured K-iteration program
        self._train_steps_cache = scan_driver.ProgramCache(name="gan")
        # the first eager iteration is a compile event (obs.profiling)
        self._first_dispatch_noted = False

    def _average_grads_(self, model: nn.Module) -> None:
        """Average ``model``'s gradients over the group in place: one flat
        exact all-reduce (none at world 1), or ``compress``'s wire."""
        grads = _grads_for_all_reduce(
            [p for p in model.parameters() if p.requires_grad],
            self.world > 1 or self.compress != "none")
        if self.compress == "none":
            collectives.psum_flat_(grads, self.group, scale=1.0 / self.world)
            return
        with torch.no_grad():
            for g, mean in zip(grads, collectives.compressed_pmean(
                    grads, self.group, mode=self.compress)):
                g.copy_(mean)

    def _average_monitored(self, model: nn.Module, numx: dict | None,
                           net: str) -> tuple[list, dict]:
        """:meth:`_average_grads_`, and with monitors on (``numx`` given)
        ``<net>_replica_grad_norm`` (the local gradients' norm before the
        reduction) into ``numx``. Returns the averaged gradients and what
        the wire recorded (the int8 clip fraction and headroom)."""
        mon = numx is not None
        if mon:
            numx[f"{net}_replica_grad_norm"] = obs_numerics.grad_norm_scalar(
                [p.grad for p in model.parameters() if p.grad is not None])
        with obs_numerics.collect(enabled=mon) as col:
            self._average_grads_(model)
        return [p.grad for p in model.parameters() if p.grad is not None], col.summary()

    def _iteration(self, real, z_d, z_g, step) -> tuple[torch.Tensor, dict]:
        """One D update, then one G update (module docstring), each taken
        by ``step(optimizer)`` once its gradients are averaged. Returns the
        replica-averaged ``(d_loss, g_loss, d_real, d_fake)`` and the
        monitors."""
        G, D = self.generator, self.discriminator
        G.train()
        D.train()
        mon = bool(self.monitors)
        numx: dict | None = {} if mon else None

        # ---- D step (the SyncBN forwards record their skew)
        self.d_optimizer.zero_grad(set_to_none=True)
        with obs_numerics.collect(enabled=mon) as d_col:
            with torch.no_grad():
                fake = G(z_d)  # train mode: G's statistics move
            real_logits = D(real)
            fake_logits = D(fake)
        d_loss, _ = self.loss_pair(real_logits, fake_logits)
        d_loss.backward()
        d_grads, d_wire = self._average_monitored(D, numx, "d")
        step(self.d_optimizer)

        # ---- G step, through the just-updated D
        self.g_optimizer.zero_grad(set_to_none=True)
        g_params = [p for p in G.parameters() if p.requires_grad]
        with obs_numerics.collect(enabled=mon) as g_col:
            g_logits = D(G(z_g))
        _, g_loss = self.loss_pair(torch.zeros_like(g_logits), g_logits)
        g_loss.backward(inputs=g_params)
        g_grads, g_wire = self._average_monitored(G, numx, "g")
        step(self.g_optimizer)

        with torch.no_grad():
            vals = torch.stack([d_loss.detach(), g_loss.detach(),
                                torch.sigmoid(real_logits).mean(),
                                torch.sigmoid(fake_logits).mean()]).float()
            if self.world > 1:
                vals = collectives.pmean(vals, self.group)
                # replica-0 buffer broadcast (DDP forward_sync_buffers)
                collectives.broadcast_(
                    [b for m in (G, D) for b in m.buffers() if b is not None],
                    self.group)
        monitors: dict = {}
        if mon:
            for net, grads in (("d", d_grads), ("g", g_grads)):
                monitors.update({f"{net}_{k}": v for k, v in
                                 obs_stepstats.grad_monitors(grads).items()})
            # both networks' buffers after the broadcast, G's under ".0",
            # D's under ".1" (the JAX step's (gr, dr) tuple path)
            buffers = [(f"{i}.{n}", b) for i, m in enumerate((G, D))
                       for n, b in m.named_buffers()]
            monitors.update(obs_stepstats.state_health(
                buffers, per_layer=self.monitors == "full"))
            numx.update(obs_numerics.merge_max(
                d_col.summary(), g_col.summary(), d_wire, g_wire))
            monitors.update(obs_numerics.cross_replica_monitors(
                numx, self.group,
                disp_keys=("d_replica_grad_norm", "g_replica_grad_norm")))
        return vals, monitors

    def train_step(self, real, z_d, z_g) -> GANStepOutput:
        """One D update, then one G update (module docstring)."""
        t0 = time.perf_counter() if not self._first_dispatch_noted else None
        real, z_d, z_g = _to_device((real, z_d, z_g), self.device)
        vals, monitors = self._iteration(real, z_d, z_g, lambda opt: opt.step())
        if t0 is not None:
            # lazy kernel builds and cuDNN's autotuning: one compile.gan event
            self._first_dispatch_noted = True
            from tpu_syncbn_torch.obs import profiling

            profiling.note_compile("gan", time.perf_counter() - t0)
        self.step_count += 1
        out = GANStepOutput(d_loss=vals[0], g_loss=vals[1],
                            metrics={"d_real": vals[2], "d_fake": vals[3]},
                            monitors=monitors)
        if flightrec.get() is not None:
            # step ring: device scalars copied to the host behind the
            # iteration, no synchronize (obs.flightrec)
            flightrec.record_step(
                self.step_count,
                metrics={"d_loss": out.d_loss, "g_loss": out.g_loss, **out.metrics},
                monitors=monitors)
        return out

    # -- K iterations as one program ----------------------------------------

    def _build_program(self, k: int, batch):
        opts = {id(opt): _ChunkOptimizer(opt, k, self.device, None)
                for opt in (self.g_optimizer, self.d_optimizer)}

        def update(step, optimizer):
            chunk = opts[id(optimizer)]
            chunk.step(chunk.lrs[step])

        def body(step, batch_):
            vals, monitors = self._iteration(*batch_, functools.partial(update, step))
            return {"d_loss": vals[0], "g_loss": vals[1],
                    "d_real": vals[2], "d_fake": vals[3],
                    **{("mon", k): v for k, v in monitors.items()}}

        def state():
            ts = [t for _, model, _ in self._nets() for t in
                  list(model.parameters()) + [b for b in model.buffers() if b is not None]]
            return ts + [t for c in opts.values() for t in c.state_tensors()]

        prog = scan_driver.build_scan_steps(body, n_steps=k, stacked=True,
                                            device=self.device, state=state)
        prog.opts = opts
        return prog.prepare(batch)

    def train_steps(self, real, z_d, z_g) -> GANStepOutput:
        """K iterations (one D and one G update each) as one program:
        every input carries a leading K axis, one slice an iteration.
        Exactly K sequential :meth:`train_step` calls (the D-then-G order,
        +2 / +3 ``num_batches_tracked`` an iteration), with stacked
        ``d_loss``/``g_loss``/``metrics`` of leading dimension K. On the
        card the K iterations are one CUDA graph, replayed once a call
        (``parallel.scan_driver``; the optimizers as
        :class:`~tpu_syncbn_torch.parallel.trainer._ChunkOptimizer` runs
        them: SGD, or Adam made ``capturable``); on the CPU the same body
        runs K times. Each distinct K builds and caches its own program."""
        batch = _to_device((real, z_d, z_g), self.device)
        k = scan_driver.scan_length(real)
        _check_capturable(self.device, self.world, self.group)
        prog = scan_driver.cached_scan_steps(
            self._train_steps_cache, (k, scan_driver._signature(batch)),
            lambda: self._build_program(k, batch))
        for opt in (self.g_optimizer, self.d_optimizer):
            prog.opts[id(opt)].fill(_schedule_lrs(opt, None, k))
        out = prog(batch)
        self.step_count += k
        res = GANStepOutput(d_loss=out["d_loss"], g_loss=out["g_loss"],
                            metrics={"d_real": out["d_real"], "d_fake": out["d_fake"]},
                            monitors={n[1]: v for n, v in out.items()
                                      if isinstance(n, tuple)})
        if flightrec.get() is not None:
            # the chunk-final slice (a view), copied to the host behind the
            # chunk with no synchronize (obs.flightrec)
            flightrec.record_step(
                self.step_count,
                metrics={"d_loss": res.d_loss[-1], "g_loss": res.g_loss[-1],
                         **{n: v[-1] for n, v in res.metrics.items()}},
                monitors={n: v[-1] for n, v in res.monitors.items()})
        return res

    @property
    def program_caches(self) -> tuple:
        return (self._train_steps_cache,)

    def sync_to_models(self) -> tuple[nn.Module, nn.Module]:
        """``(generator, discriminator)``: the port trains the modules in
        place, so they already hold the trained state."""
        return self.generator, self.discriminator

    @torch.no_grad()
    def generate(self, z) -> torch.Tensor:
        """Images from latents ``z`` with the current generator in eval
        mode (running statistics; the module's mode flag is restored).
        Every rank holds the whole generator, so each samples its own
        ``z`` with no collective."""
        z = _to_device(z, self.device)
        G = self.generator
        was_training = G.training
        G.eval()
        try:
            return G(z)
        finally:
            G.train(was_training)

    # -- checkpointing ----------------------------------------------------

    def state_dict(self) -> dict:
        """Full training state as copies: each network's ``params`` and
        ``rest`` (every buffer) by name, each optimizer's ``state_dict()``,
        and ``step_count``."""
        out = {"step_count": self.step_count}
        for net, model, opt in self._nets():
            state = _named_state(model)
            out[f"{net}_params"], out[f"{net}_rest"] = state["params"], state["rest"]
            out[f"{net}_opt_state"] = copy.deepcopy(opt.state_dict())
        return out

    def load_state_dict(self, state: dict) -> None:
        """Restore a tree produced by :meth:`state_dict` (or loaded from a
        checkpoint) in place; nothing is broadcast (every rank loads the
        same checkpoint). Raises ``ValueError`` on names or shapes that
        are not this trainer's."""
        for net, model, opt in self._nets():
            _load_named_state_(model, state[f"{net}_params"], state[f"{net}_rest"],
                               label=f"{net}_")
            # a copy: torch's load keeps the given tensors where their
            # dtype and device already fit, and the next step would then
            # update the caller's state in place
            opt.load_state_dict(copy.deepcopy(state[f"{net}_opt_state"]))
        self._train_steps_cache.clear()  # the load replaced optimizer state
        self.step_count = int(state.get("step_count", 0))

    def _nets(self):
        return (("g", self.generator, self.g_optimizer),
                ("d", self.discriminator, self.d_optimizer))
