"""The port's conditional data path against the JAX package's on the same
files and seeds: the COCO records and vocabulary of ``data/mini_coco``
(its pickle cache), ``CocoCaptions`` on the PIL route (the JAX side with
``use_native=False``) in float and uint8, the host image preprocessing,
the conditional ``SyntheticCaptions``, ``make_batch`` with images, and the
``Batcher``'s order over two epochs and from a mid-epoch batch.  Exact
equality throughout (the same numpy and PIL operations)."""

import os

import numpy as np
import pytest

from gan_image_captioning_tpu.data import coco as jcoco
from gan_image_captioning_tpu.data import images as jimages
from gan_image_captioning_tpu.data import loader as jloader
from gan_image_captioning_tpu.data import synthetic as jsynth
from gan_image_captioning_tpu.data import vocab as jvocab
from gan_image_captioning_tpu_torch.data import coco as tcoco
from gan_image_captioning_tpu_torch.data import images as timages
from gan_image_captioning_tpu_torch.data import loader as tloader
from gan_image_captioning_tpu_torch.data import synthetic as tsynth
from gan_image_captioning_tpu_torch.data import vocab as tvocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(REPO, "data", "mini_coco")
JSON = os.path.join(MINI, "dataset_coco.json")


def _coco_pair(split, **kw):
    """The JAX and the port dataset of ``split`` (val and test take the
    train split's vocabulary, as ``src/main.py`` builds them)."""
    jkw = dict(kw)
    if split != "train":
        jtrain = jcoco.CocoCaptions(JSON, MINI, "train", use_native=False,
                                    conditional=False)
        ttrain = tcoco.CocoCaptions(JSON, MINI, "train", conditional=False)
        jkw["vocab_dicts"] = (jtrain.word_to_index, jtrain.index_to_word)
        kw["vocab_dicts"] = (ttrain.word_to_index, ttrain.index_to_word)
    return (jcoco.CocoCaptions(JSON, MINI, split, use_native=False, **jkw),
            tcoco.CocoCaptions(JSON, MINI, split, **kw))


@pytest.mark.parametrize("cpi", [1, 5])
def test_coco_records_and_vocab_match_jax(cpi):
    want = jvocab.build_coco_records(JSON, MINI, "train", cpi)
    got = tvocab.build_coco_records(JSON, MINI, "train", cpi)
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]
    assert len(got[0]) == 48 * cpi
    toks = got[0][0]["tokens"] + ["no-such-word"]
    np.testing.assert_array_equal(tvocab.tokens_to_ids(toks, got[1]),
                                  jvocab.tokens_to_ids(toks, want[1]))
    assert tvocab.tokens_to_ids(["no-such-word"], got[1])[0] == tvocab.UNK


def test_coco_records_without_the_cache_match_jax(tmp_path):
    """Built from the json (no pickle under ``tmp_path``), then cached
    there in the same layout."""
    want = jvocab.build_coco_records(JSON, MINI, "val", 5, use_cache=False)
    got = tvocab.build_coco_records(JSON, str(tmp_path), "val", 5)
    assert got == want
    assert os.path.exists(tmp_path / "val_5.pkl")
    again = jvocab.build_coco_records(JSON, str(tmp_path), "val", 5)
    assert again == want


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("device_preprocess", [False, True])
def test_coco_captions_match_jax(split, device_preprocess):
    j, t = _coco_pair(split, image_size=32, captions_per_image=5,
                         device_preprocess=device_preprocess,
                         dataset_percent=0.5)
    assert len(t) == len(j) and t.vocab_size == j.vocab_size
    for i in (0, 3, len(t) - 1):
        ids, img = t.sample(i)
        jids, jimg = j.sample(i)
        np.testing.assert_array_equal(ids, jids)
        assert img.dtype == jimg.dtype == (np.uint8 if device_preprocess
                                           else np.float32)
        assert img.shape == (3, 32, 32)
        np.testing.assert_array_equal(img, jimg)


def test_unconditional_coco_yields_no_image():
    t = tcoco.CocoCaptions(JSON, MINI, "train", conditional=False)
    ids, img = t.sample(0)
    assert img is None and ids.dtype == np.int32


def test_host_preprocessing_matches_jax():
    path = os.path.join(MINI, "val2014", "mini_val_0000.jpg")
    for size in (32, 37):
        np.testing.assert_array_equal(timages.load_and_preprocess(path, size),
                                      jimages.load_and_preprocess(path, size))
        np.testing.assert_array_equal(timages.load_resize_u8(path, size),
                                      jimages.load_resize_u8(path, size))


def test_images_without_pillow_raise_import_error(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        timages.load_and_preprocess(
            os.path.join(MINI, "val2014", "mini_val_0000.jpg"), 32)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_conditional_synthetic_matches_jax(split):
    j = jsynth.SyntheticCaptions(split, num_items=20, image_size=16,
                                 conditional=True, seed=7)
    t = tsynth.SyntheticCaptions(split, num_items=20, image_size=16,
                                 conditional=True, seed=7)
    assert len(t) == len(j) == 20 and t.vocab_size == j.vocab_size
    for i in range(0, 20, 3):
        ids, img = t.sample(i)
        jids, jimg = j.sample(i)
        np.testing.assert_array_equal(ids, jids)
        assert img.dtype == np.float32 and img.shape == (3, 16, 16)
        np.testing.assert_array_equal(img, jimg)
    assert t.sample(1)[1] is not None
    assert tsynth.SyntheticCaptions(split, conditional=False).sample(1)[1] \
        is None


@pytest.mark.parametrize("kind", ["float", "uint8", "feats"])
def test_make_batch_with_images_matches_jax(kind):
    rng = np.random.default_rng(0)
    caps = [np.arange(4, 9), np.arange(10, 60), np.array([5])]
    if kind == "float":
        imgs = [rng.standard_normal((3, 4, 4)).astype(np.float32)
                for _ in caps]
    elif kind == "uint8":
        imgs = [rng.integers(0, 256, (3, 4, 4)).astype(np.uint8)
                for _ in caps]
    else:
        imgs = [rng.standard_normal(512).astype(np.float32) for _ in caps]
    want = jloader.make_batch(caps, imgs, 12, batch_size=4)
    got = tloader.make_batch(caps, imgs, 12, batch_size=4)
    key = {"float": "images", "uint8": "images_u8",
           "feats": "backbone_feats"}[kind]
    assert got.keys() == want.keys() and key in got
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _batches(batcher, start=0):
    return [b for b in batcher.iter_from(start)]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False),
                                               (False, False)])
def test_batcher_order_matches_jax(shuffle, drop_last):
    j_ds = jsynth.SyntheticCaptions("train", num_items=27, image_size=8,
                                    conditional=True)
    t_ds = tsynth.SyntheticCaptions("train", num_items=27, image_size=8,
                                    conditional=True)
    kw = dict(batch_size=5, seq_len=12, shuffle=shuffle, seed=11,
              drop_last=drop_last)
    jb = jloader.Batcher(j_ds, num_workers=1, precollate="off", **kw)
    tb = tloader.Batcher(t_ds, **kw)
    assert len(tb) == len(jb) == (5 if drop_last else 6)
    for epoch in range(2):
        got, want = _batches(tb), _batches(jb)
        _assert_same_batches(got, want)
        assert tb.epoch == jb.epoch == epoch + 1
        assert got[0]["images"].shape == (5, 3, 8, 8)
    # the next epoch from its third batch: the same order, the first two
    # batches skipped
    _assert_same_batches(_batches(tb, 2), _batches(jb, 2))
    assert tb.epoch == jb.epoch == 3
    if shuffle:
        firsts = [tloader.Batcher(t_ds, **kw) for _ in range(2)]
        firsts[1].epoch = 1
        assert not np.array_equal(next(iter(firsts[0]))["index"],
                                  next(iter(firsts[1]))["index"])


def test_batcher_pads_the_final_batch_with_zero_weight_rows():
    ds = tsynth.SyntheticCaptions("val", num_items=7)
    batches = list(tloader.Batcher(ds, 4, 12))
    last = batches[-1]
    assert last["captions"].shape == (4, 12)
    np.testing.assert_array_equal(last["weights"], [1, 1, 1, 0])
    np.testing.assert_array_equal(last["index"], [4, 5, 6, 4])
    assert "images" not in last
