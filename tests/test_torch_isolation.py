"""The port stands alone: tpu_syncbn_torch (and chip_smoke.py) import no
JAX, Flax, Optax or anything of the JAX package, and every entry point
that defaults to the card refuses to run without one instead of falling
back to the CPU."""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_syncbn_torch import (
    bench,
    data,
    gan_train,
    imagenet_resnet50,
    longcontext_train,
    models,
    nn,
    ops,
    parallel,
    parallelism_tour,
    retinanet_train,
    runtime,
    train,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tpu_syncbn_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpu_syncbn")


def _sources():
    """The package's sources, chip_smoke.py and the port's timing tools,
    in a fixed order (every test worker must collect the same
    parameters)."""
    found = [os.path.join(d, f) for d, dirs, files in os.walk(PKG)
             for f in files if f.endswith(".py") and "_build" not in d]
    tools = [os.path.join(ROOT, "tools", f)
             for f in os.listdir(os.path.join(ROOT, "tools")) if f.endswith(".py")]
    return sorted(found) + [os.path.join(ROOT, "chip_smoke.py")] + sorted(tools)


def _env():
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    return env


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, subprocess, sys\n"
        "def no_process(*a, **k): raise AssertionError('a process at import')\n"
        "subprocess.Popen = no_process  # no nvcc (or anything) runs at import\n"
        "import tpu_syncbn_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'tpu_syncbn_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "from tpu_syncbn_torch.ops import _cuda_build as cb\n"
        "built = bool(cb._LIBS or cb.LAST_BUILD)\n"
        "print(len(names), bad, built)\n"
        "sys.exit(1 if bad or built else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 20  # every subpackage and module was imported


@pytest.mark.parametrize("module", ["tpu_syncbn_torch.runtime.probe",
                                    "tpu_syncbn_torch.runtime.launcher",
                                    "tpu_syncbn_torch.launch",
                                    "tpu_syncbn_torch.runtime.native",
                                    "tpu_syncbn_torch.data",
                                    "tpu_syncbn_torch.utils",
                                    "tpu_syncbn_torch.utils.checkpoint",
                                    "tpu_syncbn_torch.parallel",
                                    "tpu_syncbn_torch.imagenet_resnet50",
                                    "tpu_syncbn_torch.models.gan",
                                    "tpu_syncbn_torch.parallel.gan_trainer",
                                    "tpu_syncbn_torch.models.retinanet",
                                    "tpu_syncbn_torch.bench",
                                    "tpu_syncbn_torch.gan_train",
                                    "tpu_syncbn_torch.retinanet_train",
                                    "tpu_syncbn_torch.parallel.scan_driver",
                                    "tpu_syncbn_torch.runtime.resilience",
                                    "tpu_syncbn_torch.testing.faults",
                                    "tpu_syncbn_torch.obs.telemetry",
                                    "tpu_syncbn_torch.parallel.collectives",
                                    "tpu_syncbn_torch.ops.quant_int8",
                                    "tpu_syncbn_torch.ops.cuda_quant",
                                    "tpu_syncbn_torch.parallel.layout",
                                    "tpu_syncbn_torch.parallel.zero",
                                    "tpu_syncbn_torch.parallel.redistribute",
                                    "tpu_syncbn_torch.parallel.tensor",
                                    "tpu_syncbn_torch.parallel.expert",
                                    "tpu_syncbn_torch.parallel.pipeline",
                                    "tpu_syncbn_torch.parallel.pipeline_schedule",
                                    "tpu_syncbn_torch.parallelism_tour"])
def test_the_runtime_entry_points_alone_load_no_jax(module):
    """The launcher, its entry point, the backend probe, the data path
    with its native bindings, meters, checkpoints, the trainer, the
    ImageNet entry point, the GAN and detection models, the GAN trainer,
    the bench, the GAN and RetinaNet entry points, the fused K-step
    driver, the resilience layer, the fault injectors, the counters, and
    the compressed collectives with their int8 kernels' dispatch and
    binding, the layouts with the ZeRO store and its redistribution, and
    tensor, expert and pipeline parallelism with the tour, each
    imported alone in a fresh process (as ``python -m ...`` starts), pull
    in nothing of JAX; the launcher's help runs."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    if module == "tpu_syncbn_torch.launch":
        r = subprocess.run([sys.executable, "-m", module, "--help"], cwd=ROOT,
                           env=_env(), capture_output=True, text=True, timeout=120)
        assert r.returncode == 0 and "--simulate-chips" in r.stdout, r.stderr


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax_or_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, node.lineno, name)


def write_cifar(root, n=48):
    """A tiny ``cifar-10-batches-py`` tree: five train batches and a test
    batch of CIFAR-10's pickled layout."""
    import pickle

    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    rs = np.random.RandomState(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (n // 6, 3072), dtype=np.uint8),
                         b"labels": rs.randint(0, 10, n // 6).tolist()}, f)
    return str(root)


def write_jpegs(root, n=8):
    from PIL import Image

    rs = np.random.RandomState(0)
    for split in ("train", "val"):
        for c in ("a", "b"):
            d = os.path.join(root, split, c)
            os.makedirs(d)
            for i in range(n):
                px = rs.randint(0, 256, (40, 48, 3), dtype=np.uint8)
                Image.fromarray(px).save(os.path.join(d, f"{i}.jpg"), quality=90)
    return str(root)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")


def test_entry_points_default_to_the_card_and_refuse_to_fall_back(no_card):
    msg = "no CUDA device"
    with pytest.raises(RuntimeError, match=msg):
        models.resnet18(num_classes=10, small_input=True, width=8)
    with pytest.raises(RuntimeError, match=msg):
        nn.BatchNorm2d(4)
    model = models.resnet18(num_classes=10, small_input=True, width=8, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with pytest.raises(RuntimeError, match=msg):
        parallel.DataParallel(model, opt, lambda m, b: m(b).sum())
    with pytest.raises(RuntimeError, match=msg):
        parallel.SpecLayout.zero()
    with pytest.raises(RuntimeError, match=msg):
        data.device_prefetch(iter([np.zeros(2)]))
    with pytest.raises(RuntimeError, match=msg):
        runtime.initialize()
    with pytest.raises(RuntimeError, match=msg):
        train.main(["--epochs", "1"])
    with pytest.raises(RuntimeError, match=msg):
        train.main(["--epochs", "1", "--data-root", os.devnull])
    with pytest.raises(RuntimeError, match=msg):
        imagenet_resnet50.main(["--epochs", "1", "--data-root", os.devnull])
    with pytest.raises(RuntimeError, match=msg):
        data.device_prefetch(iter([np.zeros(2)]), scan_steps=2)
    with pytest.raises(RuntimeError, match=msg):
        models.init_transformer_lm(0, vocab=8, d_model=16, n_heads=2,
                                   n_layers=1, d_ff=16, max_len=8)
    with pytest.raises(RuntimeError, match=msg):
        longcontext_train.main(["--steps", "1"])
    # the attention op takes its device from its tensors: a CPU tensor runs
    # the plain version only when the kernel mode allows it
    q = torch.zeros(1, 8, 2, 8)
    with ops.kernel_mode("on"), pytest.raises(RuntimeError, match="needs CUDA"):
        ops.flash_attention(q, q, q, causal=True)
    # no silent CPU fallback anywhere: the CPU runs only when asked for
    assert runtime.initialize("cpu") == torch.device("cpu")


def test_gan_detection_and_bench_entry_points_refuse_to_fall_back(no_card):
    msg = "no CUDA device"
    for build in (models.DCGANGenerator, models.DCGANDiscriminator,
                  models.SNGANDiscriminator, models.retinanet_r50_fpn):
        with pytest.raises(RuntimeError, match=msg):
            build()
    g = models.DCGANGenerator(latent_dim=8, width=16, device="cpu")
    d = models.DCGANDiscriminator(width=8, device="cpu")
    opt = torch.optim.Adam(g.parameters())
    with pytest.raises(RuntimeError, match=msg):
        parallel.GANTrainer(g, d, opt, opt)
    for main in (gan_train.main, retinanet_train.main, bench.main, parallelism_tour.main):
        with pytest.raises(RuntimeError, match=msg):
            main([])


def test_gan_example_trains_and_checkpoints_on_the_cpu_when_asked(tmp_path):
    from tpu_syncbn_torch import utils

    out = gan_train.main(["--device", "cpu", "--iters", "3", "--batch-size", "8",
                          "--arch", "sngan", "--ckpt-dir", str(tmp_path),
                          "--data-root", write_jpegs(tmp_path / "jpeg", n=4)])
    tr, samples = out["trainer"], out["samples"]
    assert out["iters"] == 3 and tr.step_count == 3
    assert samples.shape == (16, 32, 32, 3) and float(samples.abs().max()) <= 1.0
    state, step = utils.load_checkpoint(str(tmp_path), tr.state_dict())
    assert step == 3 and state["step_count"] == 3
    assert torch.equal(state["d_rest"]["conv1.u"], tr.discriminator.conv1.u)


def test_train_script_runs_on_the_cpu_when_asked():
    r = subprocess.run(
        [sys.executable, "-m", "tpu_syncbn_torch.train", "--device", "cpu",
         "--epochs", "1", "--dataset-size", "48", "--batch-size", "8",
         "--arch", "resnet18"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "done: 6 steps, final loss" in r.stdout


def test_scripts_train_on_real_data_on_the_cpu_when_asked(tmp_path):
    """train.py reads a CIFAR-10 tree, the ImageNet entry point a JPEG
    tree; both on the CPU because they are asked to."""
    r = subprocess.run(
        [sys.executable, "-m", "tpu_syncbn_torch.train", "--device", "cpu",
         "--epochs", "1", "--batch-size", "8", "--arch", "resnet18",
         "--data-root", write_cifar(tmp_path / "cifar")],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "done: 5 steps, final loss" in r.stdout  # 40 CIFAR images, not 512
    r = subprocess.run(
        [sys.executable, "-m", "tpu_syncbn_torch.imagenet_resnet50", "--device",
         "cpu", "--data-root", write_jpegs(tmp_path / "jpeg"), "--epochs", "1",
         "--image-size", "32", "--batch-size", "8"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "done: 2 steps, final val top1" in r.stdout


def test_chip_smoke_refuses_without_a_card_and_alone(no_card, tmp_path):
    """chip_smoke.py prints no result without a card, and fails in a
    directory that holds it and nothing else of the repository."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    for cwd, script in ((ROOT, "chip_smoke.py"), (tmp_path, str(alone))):
        r = subprocess.run([sys.executable, script], cwd=cwd,
                           env=dict(_env(), PYTHONPATH=""),
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout



def test_bn_forward_timer_refuses_without_a_card(no_card):
    """tools/bn_forward_times.py times nothing, and prints no times,
    without a card."""
    r = subprocess.run([sys.executable, os.path.join("tools", "bn_forward_times.py"),
                        "--tree", "."], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2, r.stdout + r.stderr
    assert "[bn-fwd]" not in r.stdout and "no CUDA device" in r.stderr
