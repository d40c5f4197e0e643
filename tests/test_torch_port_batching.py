"""The port's batching against the JAX package on the CPU: its ``Batcher``
with length buckets and precollation yields the JAX ``Batcher``'s batches,
in the same order, for the same seed (two epochs; shuffle, ``drop_last``,
over-long captions clipped to the top bucket, uint8 images and cached
features; ``iter_from`` with buckets; the precollation's budget gate and
its cache shared by the Batchers of one dataset), as
``tests/test_length_buckets.py`` and ``tests/test_precollate.py`` hold the
JAX one; ``stack_batches`` against the JAX ``stack_batches``; and
``steps.make_multi_step`` against sequential steps (as
``tests/test_multi_step.py`` does, the mesh case aside): bit-equal states
and metrics in the port (the multi-step is a loop over the same step),
and the MLE multi-step against the JAX ``make_multi_step``.

Tolerance: batches exactly equal; the JAX comparison of the multi-step,
losses rtol 1e-5 and parameters atol 1e-5, rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data import loader as jloader
from gan_image_captioning_tpu.train import steps as jsteps
from gan_image_captioning_tpu.train.state import (
    create_train_state as jcreate_train_state)
from gan_image_captioning_tpu_torch import interop
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data import loader as tloader
from gan_image_captioning_tpu_torch.train import steps as tsteps
from gan_image_captioning_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves


class VarLenDataset:
    """Captions of many lengths, some past the width (the truncation
    path); uint8 images or cached features when asked.  Plain numpy: both
    packages' Batchers read the same object."""

    def __init__(self, n=37, width=12, conditional=False, feats=False):
        self.n, self.conditional, self.feats = n, conditional, feats
        self.lens = np.random.default_rng(7).integers(1, width + 4, size=n)
        self.lens[3] = width + 6

    def __len__(self):
        return self.n

    def caption_length(self, i):
        return int(self.lens[i])

    def sample(self, i):
        rng = np.random.default_rng(1000 + i)
        toks = rng.integers(4, 50, size=self.lens[i]).astype(np.int32)
        img = None
        if self.feats:
            img = rng.normal(size=(16,)).astype(np.float32)
        elif self.conditional:
            img = rng.integers(0, 255, size=(3, 8, 8)).astype(np.uint8)
        return toks, img


def _pair(ds, **kw):
    kw = dict(dict(batch_size=8, seq_len=14), **kw)
    pre = kw.pop("precollate", "off")
    return (tloader.Batcher(ds, precollate=pre, **kw),
            jloader.Batcher(ds, num_workers=1, precollate=pre, **kw))


def _assert_same_stream(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


CASES = {
    "buckets": dict(bucket_bounds=[6, 10]),
    "buckets_shuffled_drop_last": dict(bucket_bounds=[10, 6], shuffle=True,
                                       seed=3, drop_last=True),
    "top_bucket_past_width": dict(bucket_bounds=[5, 9, 20], shuffle=True,
                                  seed=1),
    "precollated": dict(precollate="on", shuffle=True, seed=2),
    "precollated_buckets": dict(precollate="on", bucket_bounds=[6, 10],
                                shuffle=True, seed=4, drop_last=True),
    "u8_buckets": dict(conditional=True, bucket_bounds=[7],
                       precollate="on", shuffle=True, seed=5),
    "feats_buckets": dict(feats=True, bucket_bounds=[8], shuffle=True,
                          seed=6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_match_the_jax_batcher(case):
    kw = dict(CASES[case])
    ds = VarLenDataset(conditional=kw.pop("conditional", False),
                       feats=kw.pop("feats", False))
    ours, theirs = _pair(ds, **kw)
    for _ in range(2):
        _assert_same_stream(list(ours), list(theirs))
    assert len(ours) == len(theirs)
    assert ours.epoch == theirs.epoch == 2


def test_bucket_widths_and_truncation():
    ours, _ = _pair(VarLenDataset(), bucket_bounds=[6, 10])
    batches = list(ours)
    widths = {b["captions"].shape[1] for b in batches}
    assert widths == {6, 10, 14}
    for b in batches:
        real = b["weights"] > 0
        assert (b["lengths"][real] <= b["captions"].shape[1]).all()
    assert sum(int((b["weights"] > 0).sum()) for b in batches) == 37


@pytest.mark.parametrize("start", [0, 2, 5])
def test_iter_from_with_buckets_matches_jax(start):
    ds = VarLenDataset()
    kw = dict(bucket_bounds=[6, 10], shuffle=True, seed=9)
    ours, theirs = _pair(ds, **kw)
    full, _ = _pair(ds, **kw)
    _assert_same_stream(list(ours.iter_from(start)),
                        list(theirs.iter_from(start)))
    assert [b["index"].tolist() for b in list(full)[start:]] == [
        b["index"].tolist() for b in _pair(ds, **kw)[0].iter_from(start)]


def test_precollate_budget_gate(monkeypatch):
    ds = VarLenDataset(conditional=True)
    monkeypatch.setenv("GIC_PRECOLLATE_BUDGET", "64")
    auto = tloader.Batcher(ds, 8, 14, precollate="auto")
    forced = tloader.Batcher(ds, 8, 14, precollate="on")
    off = tloader.Batcher(VarLenDataset(), 8, 14, precollate="off")
    _assert_same_stream(list(auto), list(forced))
    list(off)
    assert auto._pre is None and forced._pre is not None and off._pre is None
    monkeypatch.delenv("GIC_PRECOLLATE_BUDGET")
    roomy = tloader.Batcher(VarLenDataset(), 8, 14, precollate="auto")
    list(roomy)
    assert roomy._pre is not None


def test_precollation_is_shared_by_the_batchers_of_a_dataset():
    ds = VarLenDataset(conditional=True)
    a = tloader.Batcher(ds, 8, 14, precollate="on", shuffle=True, seed=1)
    b = tloader.Batcher(ds, 4, 14, precollate="on", bucket_bounds=[6])
    c = tloader.Batcher(ds, 8, 20, precollate="on")
    for batcher in (a, b, c):
        list(batcher)
    assert a._pre is b._pre and a._pre is not c._pre
    assert sorted(ds._gic_precollated) == [14, 20]


def test_stack_batches_matches_jax():
    ds = VarLenDataset()
    ours, _ = _pair(ds, bucket_bounds=[6, 10], shuffle=True, seed=2)
    batches = list(ours)
    for k in (1, 2, 3):
        got = list(tloader.stack_batches(iter(batches), k))
        want = list(jloader.stack_batches(iter(batches), k))
        assert [c for _, c in got] == [c for _, c in want]
        for (g, _), (w, _) in zip(got, want):
            for key in w:
                np.testing.assert_array_equal(g[key], w[key])
    groups = list(tloader.stack_batches(iter(batches), 3))
    assert sum(c for _, c in groups) == len(batches)
    changes = sum(a["captions"].shape != b["captions"].shape
                  for a, b in zip(batches, batches[1:]))
    assert len(groups) >= changes + 1     # a group ends at a width change


# ------------------------------------------------------------ multi-step

KW = dict(vocab_size=40, gen_embed_dim=8, gen_hidden_dim=12,
          gen_num_layers=1, max_seq_len=6, disc_embed_dim=8, disc_num_rep=4,
          disc_filter_sizes=(2, 3), disc_num_filters=(6, 6), gen_lr=1e-3,
          disc_lr=1e-3, pretrain_lr=1e-2)
K = 3


def _host_batches(config, n, rows=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        caps = [rng.integers(4, config.vocab_size,
                             size=rng.integers(1, config.max_seq_len + 1))
                for _ in range(rows)]
        out.append(tloader.make_batch(caps, None, config.seq_len))
    return out


def _states_equal(a, b):
    for x, y in ((a.gen, b.gen), (a.disc, b.disc)):
        for (k, v), (_, w) in zip(x.state_dict().items(),
                                  y.state_dict().items()):
            assert torch.equal(v, w), k
    for name in ("pretrain_opt", "gen_opt", "disc_opt"):
        oa, ob = getattr(a, name), getattr(b, name)
        assert oa.count == ob.count
        assert all(torch.equal(oa.mu[k], ob.mu[k]) and
                   torch.equal(oa.nu[k], ob.nu[k]) for k in oa.mu)
    assert (a.gen_steps, a.disc_steps, a.temperature) == (
        b.gen_steps, b.disc_steps, b.temperature)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    if a.ema_gen is not None:
        assert all(torch.equal(a.ema_gen[k], b.ema_gen[k]) for k in a.ema_gen)


@pytest.mark.parametrize("kind,extra", [
    ("mle", {}), ("mle", dict(grad_accum=2, mle_objective="scheduled")),
    ("adv", dict(disc_train_freq=2)),
    ("adv", dict(grad_accum=2, ema_decay=0.9, noisy_labels=0.2)),
    ("adv", dict(gen_arch="transformer", disc_arch="transformer",
                 gen_num_heads=2, disc_hidden_dim=8, disc_num_heads=2,
                 disc_num_layers=1, adv_objective="reinforce",
                 rollout_num=1, rollout_stride=3))])
def test_multi_step_matches_sequential_steps(kind, extra):
    config = Config(**KW, **extra)
    batches = [tsteps.batch_to(b, "cpu") for b in _host_batches(config, K)]
    stacked = tsteps.batch_to(tloader.stack_batches(
        iter(_host_batches(config, K)), K).__next__()[0], "cpu")
    scalars = [0.0, 0.5, 1.0] if kind == "mle" else [1.0, 2.0, 3.0]
    a, b = create_train_state(config, 2), create_train_state(config, 2)
    single = (tsteps.make_mle_step if kind == "mle"
              else tsteps.make_adv_step)(config)
    seq = []
    for batch, s in zip(batches, scalars):
        a, m = single(a, batch, s)
        seq.append(m)
    b, multi = tsteps.make_multi_step(config, kind)(b, stacked, scalars)
    _states_equal(a, b)
    for k in multi:
        assert multi[k].shape == (K,)
        assert torch.equal(multi[k], torch.stack([m[k] for m in seq])), k


def test_unknown_multi_step_kind_raises():
    with pytest.raises(ValueError, match="unknown multi-step kind"):
        tsteps.make_multi_step(Config(**KW), "scst")


@pytest.fixture
def no_state_shardings():
    """No process-wide JAX state shardings: the ZeRO-1 instructor test
    (``tests/test_parallel.py``) leaves them set on its worker."""
    prev = jsteps._STATE_SHARDINGS
    jsteps.set_state_shardings(None)
    yield
    jsteps.set_state_shardings(prev)


def test_mle_multi_step_matches_jax(no_state_shardings):
    jconfig, config = JConfig(**KW, decode_impl="fused"), Config(**KW)
    jstate = jax.jit(lambda k: jcreate_train_state(jconfig, k))(
        jax.random.PRNGKey(1))
    state = interop.train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate), config)
    stacked = next(tloader.stack_batches(iter(_host_batches(config, K)), K))[0]
    jstate, jm = jsteps.make_multi_step(jconfig, "mle")(
        jstate, {k: jnp.asarray(v) for k, v in stacked.items()},
        jnp.zeros((K,), jnp.float32))
    state, m = tsteps.make_multi_step(config, "mle")(
        state, tsteps.batch_to(stacked, "cpu"), [0.0] * K)
    for k in jm:
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    want = interop.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate.gen_params))
    for k, v in state.gen.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=k)
    assert state.pretrain_opt.count == int(
        jstate.pretrain_opt_state[1][0].count) == K
