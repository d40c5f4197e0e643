"""Conditional serving on the CPU: ``{"image": [paths]}`` on the
``data/mini_coco`` JPEGs through the port's ``CaptionService`` must give
the captions of the JAX package's reference, built in the main thread
from ``load_and_preprocess`` → ``api.generator_condition(train=False)`` →
the batch greedy decode (``greedy_with_logprobs``), on the same weights: a
conditional generator exported by ``models/torch_export.generator_to_torch``
(what ``src/export_torch.py`` writes).  Logprobs within 2e-4 (float32 sums
in another order), features rtol 1e-4, atol 1e-5.  No JAX serving engine
is started; only the port's own dispatcher thread runs."""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data import coco as jcoco
from gan_image_captioning_tpu.data.images import load_and_preprocess
from gan_image_captioning_tpu.eval import decode as jdecode
from gan_image_captioning_tpu.eval.metrics import ids_to_words, strip_caption
from gan_image_captioning_tpu.models import api as japi
from gan_image_captioning_tpu.models import encoder as jenc
from gan_image_captioning_tpu.models import generator as jgen
from gan_image_captioning_tpu.models.torch_export import generator_to_torch
from gan_image_captioning_tpu_torch import serve
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.train import checkpoint as ckpt_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(REPO, "data", "mini_coco")
E, H, S, MAX_LEN, CPI = 32, 32, 32, 8, 5
FLAGS = ["--dataset", "coco", "--data-dir", MINI, "--captions-per-image",
         str(CPI), "--image-size", str(S), "--gen-embed-dim", str(E),
         "--gen-hidden-dim", str(H), "--gen-num-layers", "2",
         "--max-seq-len", str(MAX_LEN), "--device", "cpu"]
PATHS = ([os.path.join(MINI, "val2014", f"mini_val_{i:04d}.jpg")
          for i in range(6)]
         + [os.path.join(MINI, "test2014", f"mini_test_{i:04d}.jpg")
            for i in range(3)])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(conditional checkpoint, unconditional checkpoint, JAX captions,
    logprobs and features of PATHS)."""
    train = jcoco.CocoCaptions(os.path.join(MINI, "dataset_coco.json"), MINI,
                               "train", S, CPI, conditional=False,
                               use_native=False)
    jconfig = JConfig(vocab_size=train.vocab_size, gen_embed_dim=E,
                      gen_hidden_dim=H, gen_num_layers=2, max_seq_len=MAX_LEN,
                      conditional_gan=1, image_size=S)
    k_dec, k_enc = jax.random.split(jax.random.PRNGKey(17))
    params = {"decoder": jgen.init_decoder_params(k_dec, jconfig),
              "encoder": jenc.init_encoder_params(k_enc, jconfig)}
    # one train-mode pass so the running statistics are not the initial
    # ones (a served checkpoint carries trained statistics)
    warm = np.stack([load_and_preprocess(p, S) for p in PATHS[:4]])
    _, stats = jenc.encode(params["encoder"], jnp.asarray(warm), jconfig,
                           train=True)
    params["encoder"] = dict(params["encoder"], bn_stats=stats)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    d = tmp_path_factory.mktemp("ckpt")
    cond_path, uncond_path = str(d / "cond.ckpt"), str(d / "uncond.ckpt")
    torch.save(generator_to_torch(np_params), cond_path)
    torch.save(generator_to_torch({"decoder": np_params["decoder"]}),
               uncond_path)

    imgs = np.stack([load_and_preprocess(p, S) for p in PATHS])
    batch = {"captions": np.zeros((len(PATHS), jconfig.seq_len), np.int32),
             "images": jnp.asarray(imgs)}
    cond, _ = japi.generator_condition(jconfig, params, batch, train=False)
    feats = cond["features"]
    ids, lps = jdecode.greedy_with_logprobs(params, feats, jconfig)
    captions = [" ".join(ids_to_words(strip_caption(r), train.index_to_word))
                for r in np.asarray(ids)]
    assert len(set(captions)) > 1    # the images steer the captions
    return (cond_path, uncond_path, captions, np.asarray(lps),
            np.asarray(feats), imgs)


def _service(path, *extra):
    return serve.CaptionService(serve.parse_args(
        ["--checkpoint", path, *FLAGS, *extra]))


@pytest.mark.parametrize("engine", [[], ["--serve-continuous",
                                         "--serve-exact"]])
def test_image_request_matches_jax(reference, engine):
    cond_path, _, captions, lps, _, _ = reference
    service = _service(cond_path, "--conditional-gan", "1", *engine)
    try:
        resp = service.handle_request({"image": PATHS})
        assert resp["captions"] == captions
        np.testing.assert_allclose(resp["logprobs"], lps, atol=2e-4)
        one = service.handle_request({"image": PATHS[2]})
        assert one["captions"] == captions[2:3]
    finally:
        service.close()


def test_device_part_matches_jax(reference):
    """``features_from_images`` / ``caption_images`` take the normalized
    ``[N, 3, S, S]`` array (the host part stays out)."""
    cond_path, _, captions, _, feats, imgs = reference
    service = _service(cond_path, "--conditional-gan", "1")
    try:
        before = {k: v.clone()
                  for k, v in service.generator.state_dict().items()}
        got = service.features_from_images(imgs)
        np.testing.assert_allclose(got, feats, rtol=1e-4, atol=1e-5)
        assert service.caption_images(imgs)["captions"] == captions
        # eval mode: the running statistics stay
        after = service.generator.state_dict()
        assert all(torch.equal(v, after[k]) for k, v in before.items())
    finally:
        service.close()


def test_stdin_loop_serves_images(reference, monkeypatch, capsys):
    cond_path, _, captions, _, _, _ = reference
    reqs = [{"image": PATHS[:3]}, {"image": []}, {"n": 2}, {"stats": True}]
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "".join(json.dumps(r) + "\n" for r in reqs)))
    serve.main(["--checkpoint", cond_path, *FLAGS, "--conditional-gan", "1"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0]["status"] == "ready"
    assert lines[1]["captions"] == captions[:3]
    assert "error" in lines[2]
    assert len(lines[3]["captions"]) == 2
    assert lines[4]["coalescing"]["device_calls"] >= 2


def test_unconditional_service_refuses_images(reference):
    _, uncond_path, _, _, _, _ = reference
    service = _service(uncond_path)
    try:
        resp = service.handle_request({"image": PATHS[0]})
        assert resp == {"error": "checkpoint is unconditional; use {'n': k}"}
    finally:
        service.close()


def test_checkpoint_conditionality_must_match(reference, tmp_path):
    cond_path, uncond_path, _, _, _, _ = reference
    with pytest.raises(ValueError, match="conditionality"):
        _service(cond_path)
    with pytest.raises(ValueError, match="conditionality"):
        _service(uncond_path, "--conditional-gan", "1")
    # the adversarial form carries the flag
    args = serve.parse_args(["--checkpoint", cond_path, *FLAGS,
                             "--conditional-gan", "1"])
    serve.build_vocab(args)
    config = serve.config_from_args(args)
    gen, _ = ckpt_lib.load_generator_checkpoint(cond_path, config)
    adv = str(tmp_path / "adv_model.ckpt")
    ckpt_lib.save_generator_checkpoint(adv, gen, {"w": torch.zeros(2)})
    assert torch.load(adv, weights_only=True)["conditional"] is True
    with pytest.raises(ValueError, match="conditionality"):
        ckpt_lib.load_generator_checkpoint(
            adv, Config(**{**config.__dict__, "conditional_gan": 0}))
    again, disc = ckpt_lib.load_generator_checkpoint(adv, config)
    assert set(disc) == {"w"}
    for k, v in gen.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k


def test_checkpoint_keys_are_the_reference_layout(reference, tmp_path):
    """What the port saves is what the JAX export writes: the backbone
    under the reference encoder's ``nn.Sequential`` numbers."""
    cond_path, _, _, _, _, _ = reference
    args = serve.parse_args(["--checkpoint", cond_path, *FLAGS,
                             "--conditional-gan", "1"])
    serve.build_vocab(args)
    gen, _ = ckpt_lib.load_generator_checkpoint(cond_path,
                                                serve.config_from_args(args))
    out = str(tmp_path / "again.ckpt")
    ckpt_lib.save_generator_checkpoint(out, gen)
    want = torch.load(cond_path, weights_only=True)
    got = torch.load(out, weights_only=True)
    assert got.keys() == want.keys()
    assert "encoder.resnet.0.weight" in got and "encoder.resnet.7.1.conv2.weight" in got
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_seeded_conditional_service_answers_images():
    service = serve.CaptionService(serve.parse_args(
        ["--init-seed", "0", *FLAGS, "--conditional-gan", "1"]))
    try:
        resp = service.handle_request({"image": PATHS[:2]})
        assert len(resp["captions"]) == 2
        assert all(np.isfinite(resp["logprobs"]))
    finally:
        service.close()
