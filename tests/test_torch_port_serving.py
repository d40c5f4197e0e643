"""The port's CoalescingBatcher: buckets, padding, coalescing, admission
control, close() and stats().  The decode is a fake that echoes each row's
marker, so every result can be traced back to its request."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu_torch.serving import (CoalescingBatcher,
                                                    EngineOverloaded)

E, T = 4, 3


class FakeDecode:
    """ids [b, T] = the row's marker (column 0); logprob = -marker.  Can
    be held (``hold``) to let requests queue up behind a running decode."""

    def __init__(self):
        self.chunks = []
        self.entered = threading.Event()
        self.release = threading.Event()
        self.release.set()

    def hold(self):
        self.release.clear()
        self.entered.clear()

    def __call__(self, feats):
        self.chunks.append(feats.shape[0])
        self.entered.set()
        assert self.release.wait(timeout=10)
        marker = torch.from_numpy(feats[:, 0].copy())
        if (marker < 0).any():
            raise ValueError("poisoned row")
        return marker.to(torch.int32)[:, None].repeat(1, T), -marker


def _rows(*markers):
    f = np.zeros((len(markers), E), np.float32)
    f[:, 0] = markers
    return f


@pytest.fixture
def engine():
    made = []

    def make(**kw):
        fake = FakeDecode()
        b = CoalescingBatcher(fake, kw.pop("batch_size", 8), E, **kw)
        made.append((b, fake))
        return b, fake

    yield make
    for b, fake in made:
        fake.release.set()
        b.close()
        assert not b._thread.is_alive()


def _result(fut):
    return fut.result(timeout=10)


def test_pads_to_batch_and_returns_own_rows(engine):
    b, fake = engine()
    ids, lps = _result(b.submit(_rows(3, 4, 5)))
    assert ids.tolist() == [[3] * T, [4] * T, [5] * T]
    assert lps.tolist() == [-3, -4, -5]
    assert fake.chunks == [8]
    assert b.stats() == {"requests": 1, "device_calls": 1,
                         "rows_requested": 3, "rows_dispatched": 8,
                         "padding_frac": 0.625, "rejected": 0}


def test_buckets_take_the_smallest_fit(engine):
    b, fake = engine(bucket_sizes=[1, 2, 4])
    assert b.bucket_sizes == [1, 2, 4, 8]
    _result(b.submit(_rows(1)))
    _result(b.submit(_rows(*range(1, 6))))
    ids, _ = _result(b.submit(_rows(*range(1, 12))))
    assert ids[:, 0].tolist() == list(range(1, 12))
    assert fake.chunks == [1, 8, 8, 4]     # 11 rows = 8 + 3 → bucket 4
    assert b.stats()["device_calls"] == 4


def test_bucket_above_batch_size_is_refused():
    with pytest.raises(ValueError):
        CoalescingBatcher(FakeDecode(), 4, E, bucket_sizes=[2, 8])


def test_concurrent_requests_coalesce(engine):
    b, fake = engine()
    fake.hold()
    first = b.submit(_rows(1))
    assert fake.entered.wait(timeout=10)
    queued = [b.submit(_rows(10 + i)) for i in range(5)]
    fake.release.set()
    assert _result(first)[0][:, 0].tolist() == [1]
    for i, fut in enumerate(queued):
        assert _result(fut)[0][:, 0].tolist() == [10 + i]
    # the five queued requests shared one decode
    assert fake.chunks == [8, 8]
    assert b.stats()["requests"] == 6


def test_max_pending_rejects_fast(engine):
    b, fake = engine(max_pending=2)
    fake.hold()
    b.submit(_rows(1))
    assert fake.entered.wait(timeout=10)
    b.submit(_rows(2))
    b.submit(_rows(3))
    with pytest.raises(EngineOverloaded):
        b.submit(_rows(4))
    assert b.stats()["rejected"] == 1


def test_close_fails_what_was_never_dispatched(engine):
    b, fake = engine()
    fake.hold()
    running = b.submit(_rows(1))
    assert fake.entered.wait(timeout=10)
    waiting = [b.submit(_rows(2)), b.submit(_rows(3))]
    closer = threading.Thread(target=b.close)
    closer.start()
    deadline = time.monotonic() + 10
    while not b._stop and time.monotonic() < deadline:
        time.sleep(0.01)
    fake.release.set()
    closer.join(timeout=10)
    assert not closer.is_alive()
    assert _result(running)[0][:, 0].tolist() == [1]
    for fut in waiting:
        with pytest.raises(RuntimeError, match="closed"):
            _result(fut)
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(_rows(4))


def test_a_failed_decode_fails_only_its_requests(engine):
    b, _ = engine()
    with pytest.raises(ValueError, match="poisoned"):
        _result(b.submit(_rows(-1)))
    assert _result(b.submit(_rows(7)))[0][:, 0].tolist() == [7]


@pytest.mark.parametrize("bad", [np.zeros((0, E)), np.zeros(E),
                                 np.zeros((2, E + 1))])
def test_submit_checks_row_shape(engine, bad):
    b, _ = engine()
    with pytest.raises(ValueError):
        b.submit(bad)
    assert b.stats()["requests"] == 0


def test_many_submitting_threads_get_their_own_rows(engine):
    """More submitters than cores, with a short switch interval: every
    request gets exactly its rows back and no counter loses an update."""
    b, fake = engine(bucket_sizes=[1, 2, 4])
    n_threads, per_thread = 16, 20
    errors = []

    def client(tid):
        try:
            for i in range(per_thread):
                marker = tid * 1000 + i + 1
                k = 1 + (i % 3)
                ids, lps = b.submit(_rows(*[marker] * k)).result(timeout=30)
                assert ids[:, 0].tolist() == [marker] * k
                assert lps.tolist() == [-marker] * k
        except Exception as exc:  # reported below, in the main thread
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    stats = b.stats()
    rows = n_threads * sum(1 + (i % 3) for i in range(per_thread))
    assert stats["requests"] == n_threads * per_thread
    assert stats["rows_requested"] == rows
    assert stats["rows_dispatched"] == sum(fake.chunks)
