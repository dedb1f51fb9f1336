"""The port's host transforms against tpu_syncbn.data.transforms: the same
inputs and seeds give index-exact crops and bit-exact pixels, transform by
transform and composed, after ``reseed`` and after a pickle round trip
(what a process worker receives). Exact equality throughout: both sides
run the same numpy and PIL code."""

import pickle

import numpy as np
import pytest

from tpu_syncbn.data import transforms as JT
from tpu_syncbn_torch.data import transforms as TT


def image(h=37, w=53, dtype=np.uint8, seed=0, channels=3):
    rs = np.random.RandomState(seed)
    shape = (h, w) if channels is None else (h, w, channels)
    if dtype == np.uint8:
        return rs.randint(0, 256, shape).astype(np.uint8)
    return (rs.randn(*shape) * 3).astype(dtype)


def both(name, *args, **kw):
    return getattr(JT, name)(*args, **kw), getattr(TT, name)(*args, **kw)


def assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


RANDOM = [
    ("RandomHorizontalFlip", (), {}),
    ("RandomHorizontalFlip", (0.3,), {}),
    ("RandomCrop", (32,), {}),
    ("RandomCrop", (30,), {"padding": 2, "padding_mode": "reflect"}),
    ("RandomResizedCrop", (24,), {}),
    ("RandomResizedCrop", (16,), {"interpolation": "nearest"}),
    # an input too thin for any draw: the centre-crop fallback
    ("RandomResizedCrop", (8,), {"scale": (0.9, 1.0), "ratio": (8.0, 9.0)}),
]


@pytest.mark.parametrize("name,args,kw", RANDOM, ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_random_transforms_draw_and_compute_the_same(name, args, kw, dtype):
    j, t = both(name, *args, seed=11, **kw)
    for i in range(12):
        x = image(dtype=dtype, seed=i)
        assert_same(t(x), j(x))


@pytest.mark.parametrize("name,args,kw", [
    ("Resize", (20,), {}),
    ("Resize", (64,), {}),
    ("Resize", (20,), {"interpolation": "nearest"}),
    ("ResizeShortestEdge", (24,), {}),
    ("ResizeShortestEdge", (37,), {}),  # already that size: returned as is
    ("CenterCrop", (30,), {}),
    ("ToFloat", (), {}),
    ("Normalize", ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)), {}),
], ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_deterministic_transforms_compute_the_same(name, args, kw, dtype):
    j, t = both(name, *args, **kw)
    for x in (image(dtype=dtype), image(49, 31, dtype=dtype, seed=1)):
        assert_same(t(x), j(x))


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
def test_bilinear_resize_of_one_channel_and_integer_images(dtype):
    """The per-channel 'F'-mode path, rounded back to an integer dtype."""
    for channels in (None, 1, 2):
        x = image(dtype=np.float32, channels=channels) * 20
        x = x.astype(dtype)
        for size in (11, (13, 70)):
            assert_same(TT._resize_bilinear(x, size), JT._resize_bilinear(x, size))


def imagenet_pipelines(mod, size, seed):
    T = mod
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    return (
        T.Compose([T.RandomResizedCrop(size, seed=seed),
                   T.RandomHorizontalFlip(seed=seed + 1),
                   T.ToFloat(), T.Normalize(mean, std)]),
        T.Compose([T.ResizeShortestEdge(size * 256 // 224), T.CenterCrop(size),
                   T.ToFloat(), T.Normalize(mean, std)]),
        T.Compose([T.RandomCrop(size, padding=4, seed=seed),
                   T.RandomHorizontalFlip(seed=seed + 1), T.ToFloat()]),
    )


@pytest.mark.parametrize("which", [0, 1, 2], ids=["train", "eval", "cifar"])
def test_composed_pipelines_and_reseed(which):
    j = imagenet_pipelines(JT, 24, seed=3)[which]
    t = imagenet_pipelines(TT, 24, seed=3)[which]
    xs = [image(40 + i, 60 - i, seed=i) for i in range(8)]
    for x in xs:
        assert_same(t(x), j(x))
    j.reseed(1000 + 7)
    t.reseed(1000 + 7)
    for x in xs:
        assert_same(t(x), j(x))


def test_reseed_restarts_the_draws():
    t = imagenet_pipelines(TT, 24, seed=3)[0]
    x = image(50, 60)
    t.reseed(5)
    first = [t(x) for _ in range(4)]
    t.reseed(5)
    assert all(np.array_equal(a, t(x)) for a in first)
    t.reseed(6)
    assert not all(np.array_equal(a, t(x)) for a in first)


def test_a_pickled_pipeline_continues_the_same_draws():
    """A process worker gets a pickled copy: its generator state goes with
    it (the lock is made anew), and the copy draws what the JAX package's
    copy draws."""
    j = imagenet_pipelines(JT, 24, seed=9)[0]
    t = imagenet_pipelines(TT, 24, seed=9)[0]
    x = image(45, 61)
    assert_same(t(x), j(x))  # advance both before pickling
    jc, tc = pickle.loads(pickle.dumps(j)), pickle.loads(pickle.dumps(t))
    for _ in range(5):
        got = tc(x)
        assert_same(got, jc(x))
        assert_same(got, t(x))  # the original continues alike
    assert tc.transforms[0]._draws._lock is not t.transforms[0]._draws._lock


def test_shared_generator_injection():
    jr, tr = np.random.RandomState(4), np.random.RandomState(4)
    j = JT.Compose([JT.RandomCrop(28, rng=jr), JT.RandomHorizontalFlip(rng=jr)])
    t = TT.Compose([TT.RandomCrop(28, rng=tr), TT.RandomHorizontalFlip(rng=tr)])
    for i in range(6):
        x = image(dtype=np.float32, seed=i)
        assert_same(t(x), j(x))


@pytest.mark.parametrize("call,match", [
    (lambda T: T.CenterCrop(64)(image()), "CenterCrop"),
    (lambda T: T.RandomCrop(64, padding=1, seed=0)(image()), "larger than padded"),
    (lambda T: T.Resize(8, interpolation="cubic")(image()), "interpolation"),
])
def test_the_same_errors(call, match):
    for mod in (JT, TT):
        with pytest.raises(ValueError, match=match):
            call(mod)
