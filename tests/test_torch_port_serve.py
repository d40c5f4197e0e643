"""The whole ported serving path on the CPU: a checkpoint exported from the JAX
package (``models/torch_export.generator_to_torch``, what
``src/export_torch.py`` writes) served by the port's ``CaptionService``
must give the captions and logprobs of the JAX package's
``greedy_with_logprobs`` + ``strip_caption``/``ids_to_words`` on the same
feature rows — through ``handle_request`` and through ``serve.main``'s
stdin loop.  The JAX reference runs in the main thread; only the port's
own (torch-only) dispatcher thread is started."""

import io
import json
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.synthetic import synthetic_vocab as jvocab
from gan_image_captioning_tpu.eval import decode as jdecode
from gan_image_captioning_tpu.eval.metrics import ids_to_words, strip_caption
from gan_image_captioning_tpu.models import generator as jgen
from gan_image_captioning_tpu.models.torch_export import generator_to_torch
from gan_image_captioning_tpu_torch import serve

# 35 synthetic words padded to 40 (--vocab-multiple): most ids are words
V, E, H, MAX_LEN = 40, 32, 32, 6
FLAGS = ["--dataset", "synthetic", "--vocab-multiple", str(V),
         "--gen-embed-dim", str(E), "--gen-hidden-dim", str(H),
         "--gen-num-layers", "2", "--max-seq-len", str(MAX_LEN)]
N = 3


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(checkpoint path, feature rows, JAX captions, JAX logprobs)."""
    jconfig = JConfig(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                      gen_num_layers=2, max_seq_len=MAX_LEN)
    params = {"decoder": jgen.init_decoder_params(jax.random.PRNGKey(21),
                                                  jconfig)}
    path = str(tmp_path_factory.mktemp("ckpt") / "pretrained_model.ckpt")
    torch.save(generator_to_torch(jax.tree_util.tree_map(np.asarray, params)),
               path)
    feats = np.random.default_rng(8).standard_normal((N, E)).astype(
        np.float32)
    ids, lps = jdecode.greedy_with_logprobs(params, jnp.asarray(feats),
                                            jconfig)
    i2w = jvocab()[1]
    captions = [" ".join(ids_to_words(strip_caption(r), i2w))
                for r in np.asarray(ids)]
    assert len(set(captions)) > 1   # random rows: distinct captions
    return path, feats, captions, np.asarray(lps)


def _service(path, *extra):
    return serve.CaptionService(serve.parse_args(
        ["--checkpoint", path, "--device", "cpu", *FLAGS, *extra]))


def test_service_matches_jax(exported, monkeypatch):
    path, feats, captions, lps = exported
    service = _service(path)
    try:
        monkeypatch.setattr(service, "_features_unconditional",
                            lambda n: feats[:n])
        resp = service.handle_request({"n": N})
        assert resp["captions"] == captions
        np.testing.assert_allclose(resp["logprobs"], lps, atol=2e-4)
        stats = service.handle_request({"stats": True})["coalescing"]
        assert stats["device_calls"] == 2 and stats["rows_requested"] == 4
    finally:
        service.close()


def test_stdin_round_trip_matches_jax(exported, monkeypatch, capsys):
    path, feats, captions, lps = exported
    monkeypatch.setattr(serve.CaptionService, "_features_unconditional",
                        lambda self, n: feats[:n])
    lines = [{"n": N}, {"stats": True}, {"image": "cat.jpg"}, {"n": 0}]
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "".join(json.dumps(r) + "\n" for r in lines) + "not json\n"))
    serve.main(["--checkpoint", path, "--device", "cpu", *FLAGS])
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert out[0] == {"status": "ready", "vocab_size": V, "device": "cpu"}
    assert out[1]["captions"] == captions
    np.testing.assert_allclose(out[1]["logprobs"], lps, atol=2e-4)
    assert out[2]["coalescing"]["device_calls"] == 2
    assert out[2]["checkpoint"] == path
    # the JAX service's answer to an image on an unconditional checkpoint
    assert out[3] == {"error": "checkpoint is unconditional; use {'n': k}"}
    assert "error" in out[4] and "error" in out[5]


def test_unconditional_rows_are_start_token_embeddings(exported):
    path, _, _, _ = exported
    service = _service(path)
    try:
        rows = service._features_unconditional(2)
        emb = service.generator.decoder.embed.weight
        np.testing.assert_array_equal(rows, emb[[1, 1]].numpy())
        resp = service.handle_request({"n": 2})
        assert len(set(resp["captions"])) == 1
    finally:
        service.close()


def test_tcp_round_trip(exported):
    path, _, _, _ = exported
    service = _service(path, "--serve-buckets", "auto")
    srv = serve.make_tcp_server(service, 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        assert service.batcher.bucket_sizes == [1, 2, 4, 8]
        with socket.create_connection(srv.server_address, timeout=30) as s:
            s.sendall(b'{"n": 2}\n')
            resp = json.loads(s.makefile().readline())
        assert len(resp["captions"]) == 2
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        service.close()
    assert not thread.is_alive()


def test_seeded_start_is_deterministic():
    args = ["--init-seed", "4", "--device", "cpu", *FLAGS]
    caps = []
    for extra in ([], [], ["--init-sweep"]):
        service = serve.CaptionService(serve.parse_args(args + extra))
        try:
            caps.append(service.handle_request({"n": 1})["captions"])
            assert service.checkpoint_path == "init-seed:4"
        finally:
            service.close()
    assert caps[0] == caps[1]


def test_needs_exactly_one_weight_source(exported):
    path, _, _, _ = exported
    for argv in (FLAGS, ["--checkpoint", path, "--init-seed", "1", *FLAGS]):
        with pytest.raises(SystemExit):
            serve.parse_args(argv)


@pytest.mark.parametrize("extra", [["--beam-size", "4"]])
def test_ported_decode_options_start(exported, monkeypatch, extra):
    """``--beam-size 4`` (refused until beam search was ported) starts and
    answers the rows with the JAX package's beam search on them."""
    path, feats, _, _ = exported
    jconfig = JConfig(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                      gen_num_layers=2, max_seq_len=MAX_LEN)
    params = {"decoder": jgen.init_decoder_params(jax.random.PRNGKey(21),
                                                  jconfig)}
    ids, scores = jdecode.beam_search(params, jnp.asarray(feats), jconfig,
                                      beam_size=4)
    i2w = jvocab()[1]
    service = _service(path, *extra)
    try:
        monkeypatch.setattr(service, "_features_unconditional",
                            lambda n: feats[:n])
        resp = service.handle_request({"n": N})
        assert resp["captions"] == [" ".join(ids_to_words(strip_caption(r),
                                                          i2w))
                                    for r in np.asarray(ids)]
        np.testing.assert_allclose(resp["logprobs"], np.asarray(scores),
                                   atol=2e-4)
    finally:
        service.close()


@pytest.mark.parametrize("extra,err", [
    (["--device", "tpu"], RuntimeError)])
def test_unported_options_raise_at_startup(extra, err):
    with pytest.raises(err):
        serve.CaptionService(serve.parse_args(
            ["--init-seed", "0", *FLAGS, *extra]))


def test_default_device_is_cuda_and_never_falls_back():
    args = serve.parse_args(["--init-seed", "0", *FLAGS])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.CaptionService(args)


@pytest.mark.parametrize("extra", [
    ["--gen-arch", "gpt2"],
    ["--conditional-gan", "1", "--encoder-arch", "vit", "--image-size", "32"]])
def test_config5_options_serve(extra, monkeypatch):
    """Options refused at startup until config5 was ported: the GPT-2
    geometry serves ``{"n": k}``, the ViT-conditioned LSTM serves images
    (random weights from the seed, plain decode on the CPU; two of the
    ViT's blocks at its width)."""
    from gan_image_captioning_tpu_torch.models import vit as tvit

    monkeypatch.setattr(tvit, "DEPTH", 2)
    service = serve.CaptionService(serve.parse_args(
        ["--init-seed", "0", *FLAGS, *extra, "--device", "cpu"]))
    try:
        if "--gen-arch" in extra:
            assert (service.config.gen_embed_dim,
                    service.config.gen_num_layers) == (768, 12)
            resp = service.handle_request({"n": 2})
        else:
            assert service.generator.encoder.backbone is \
                service.generator.encoder.vit
            resp = service.caption_images(np.random.default_rng(0).standard_normal(
                (2, 3, 32, 32)).astype(np.float32))
        assert len(resp["captions"]) == 2
        assert all(np.isfinite(resp["logprobs"]))
    finally:
        service.close()
