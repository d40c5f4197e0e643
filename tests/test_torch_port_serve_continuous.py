"""The port's serve entry point with the continuous engine, the adaptive
decode and ``--quantize``, on the CPU: a checkpoint exported from the JAX
package, served by ``serve.main`` (stdin and TCP) and ``CaptionService``,
must answer with the captions and logprobs of the JAX package's batch
decode on the same feature rows (``greedy_with_logprobs``, or
``decode_sample_q_serve`` on the same quantized decoder, interpret mode),
run in this (main) thread.  ``{"stream": true}`` sends one
``{"row", "partial", "done"}`` line per chunk that commits tokens before
the response."""

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
from gan_image_captioning_tpu.kernels.decode_sample import (
    decode_sample_q_serve as jq_serve)
from gan_image_captioning_tpu.models import generator as jgen
from gan_image_captioning_tpu.models.torch_export import generator_to_torch
from gan_image_captioning_tpu.ops import quantize as jq
from gan_image_captioning_tpu_torch import serve

# 35 synthetic words padded to 40 (--vocab-multiple): most ids are words
V, E, H, MAX_LEN = 40, 32, 32, 6
FLAGS = ["--dataset", "synthetic", "--vocab-multiple", str(V),
         "--gen-embed-dim", str(E), "--gen-hidden-dim", str(H),
         "--gen-num-layers", "2", "--max-seq-len", str(MAX_LEN),
         "--device", "cpu"]
N = 3
QUANT = {"none": [], "int8": ["--quantize", "int8"],
         "int4": ["--quantize", "int4"]}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("GIC_KERNEL_INTERPRET", "1")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(checkpoint path, feature rows, JAX params, JAX config)."""
    jconfig = JConfig(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                      gen_num_layers=2, max_seq_len=MAX_LEN)
    params = {"decoder": jgen.init_decoder_params(jax.random.PRNGKey(21),
                                                  jconfig)}
    path = str(tmp_path_factory.mktemp("ckpt") / "pretrained_model.ckpt")
    torch.save(generator_to_torch(jax.tree_util.tree_map(np.asarray, params)),
               path)
    feats = np.random.default_rng(8).standard_normal((N, E)).astype(
        np.float32)
    return path, feats, params, jconfig


def _reference(exported, quantize="none", n=N):
    """The JAX package's captions and logprobs of the first ``n`` rows."""
    _, feats, params, jconfig = exported
    x = jnp.asarray(feats[:n])
    if quantize == "none":
        ids, lp = jdecode.greedy_with_logprobs(params, x, jconfig)
    else:
        bits = 8 if quantize == "int8" else 4
        qdec = jq.quantize_lstm_decoder(params["decoder"], bits=bits,
                                        pack_int4=bits == 4)
        ids, lps = jq_serve(x, qdec, jconfig.seq_len, bits=bits)
        lp = jdecode.masked_logprob_sum(ids, lps)
    i2w = jvocab()[1]
    return ([" ".join(ids_to_words(strip_caption(r), i2w))
             for r in np.asarray(ids)], np.asarray(lp))


def _run_main(monkeypatch, capsys, exported, requests, extra):
    path, feats, _, _ = exported
    monkeypatch.setattr(serve.CaptionService, "_features_unconditional",
                        lambda self, n: feats[:n])
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "".join(json.dumps(r) + "\n" for r in requests)))
    serve.main(["--checkpoint", path, *FLAGS, *extra])
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


def _check_stream(lines, resp, n):
    """``lines``: the stream lines of one request before its response."""
    for j in range(n):
        rows = [ln for ln in lines if ln["row"] == j]
        assert rows and rows[-1]["done"] is True
        assert all(not ln["done"] for ln in rows[:-1])
        for a, b in zip(rows, rows[1:]):      # each partial extends the last
            assert b["partial"].startswith(a["partial"])
        assert rows[-1]["partial"] == resp["captions"][j]


@pytest.mark.parametrize("quantize", ["none", "int8", "int4"])
def test_stdin_continuous_matches_jax(exported, monkeypatch, capsys,
                                      quantize):
    captions, lps = _reference(exported, quantize)
    assert len(set(captions)) > 1
    reqs = [{"n": N}, {"n": 2, "stream": True}, {"stats": True}]
    out = _run_main(monkeypatch, capsys, exported, reqs,
                    ["--serve-continuous", "--serve-chunk-steps", "3",
                     *QUANT[quantize]])
    assert out[0]["status"] == "ready"
    assert out[1]["captions"] == captions
    np.testing.assert_allclose(out[1]["logprobs"], lps, atol=2e-4)
    stream = [ln for ln in out[2:] if "row" in ln]
    resp = out[2 + len(stream)]
    assert len(stream) >= 2 and resp["captions"] == captions[:2]
    _check_stream(stream, resp, 2)
    stats = out[3 + len(stream)]
    cont = stats["continuous"]
    # warm-up 1 + 3 + 2 captions; the coalescing engine served none
    assert cont["completed"] == 6 and cont["active_slots"] == 0
    assert cont["device_calls"] >= 3 and 0 < cont["occupancy"] <= 1
    assert stats["coalescing"]["device_calls"] == 0


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_serve_exact_returns_the_full_decode(exported, quantize):
    """--serve-exact: no early release, every slot runs the T steps."""
    path, feats, params, jconfig = exported
    service = serve.CaptionService(serve.parse_args(
        ["--checkpoint", path, *FLAGS, "--serve-continuous", "--serve-exact",
         "--serve-chunk-steps", "5", *QUANT[quantize]]))
    try:
        assert service.continuous.early_exit is False
        assert service.continuous.K == 5
        ids, _ = service._continuous(feats, None)
    finally:
        service.close()
    if quantize == "none":
        ref, _ = jdecode.greedy_with_logprobs(params, jnp.asarray(feats),
                                              jconfig)
    else:
        qdec = jq.quantize_lstm_decoder(params["decoder"], bits=8)
        ref, _ = jq_serve(jnp.asarray(feats), qdec, jconfig.seq_len)
    np.testing.assert_array_equal(ids, np.asarray(ref))


@pytest.mark.parametrize("quantize", ["none", "int8", "int4"])
def test_adaptive_chunk_service_matches_jax(exported, monkeypatch, capsys,
                                            quantize):
    captions, lps = _reference(exported, quantize)
    out = _run_main(monkeypatch, capsys, exported,
                    [{"n": N}, {"stats": True}],
                    ["--serve-adaptive-chunk", "4", *QUANT[quantize]])
    assert out[1]["captions"] == captions
    np.testing.assert_allclose(out[1]["logprobs"], lps, atol=2e-4)
    assert "continuous" not in out[2]
    assert out[2]["coalescing"]["device_calls"] == 2     # warm-up + request


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_coalescing_service_serves_the_quantized_decoder(
        exported, monkeypatch, capsys, quantize):
    captions, lps = _reference(exported, quantize)
    out = _run_main(monkeypatch, capsys, exported, [{"n": N}],
                    QUANT[quantize])
    assert out[1]["captions"] == captions
    np.testing.assert_allclose(out[1]["logprobs"], lps, atol=2e-4)


def test_stream_needs_the_continuous_engine(exported, monkeypatch, capsys):
    out = _run_main(monkeypatch, capsys, exported,
                    [{"n": 1, "stream": True}], [])
    assert "streaming needs --serve-continuous" in out[1]["error"]


def test_tcp_stream_round_trip(exported):
    path, _, _, _ = exported
    service = serve.CaptionService(serve.parse_args(
        ["--checkpoint", path, *FLAGS, "--serve-continuous",
         "--serve-chunk-steps", "2"]))
    srv = serve.make_tcp_server(service, 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        # the reader is closed with the socket, so the handler sees EOF
        with socket.create_connection(srv.server_address, timeout=30) as s, \
                s.makefile() as f:
            s.sendall(b'{"n": 2, "stream": true}\n{"stats": true}\n')
            lines = []
            while True:
                lines.append(json.loads(f.readline()))
                if "captions" in lines[-1]:
                    break
            stats = json.loads(f.readline())
        _check_stream(lines[:-1], lines[-1], 2)
        assert stats["continuous"]["completed"] == 3
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        service.close()
    assert not thread.is_alive()
    assert not service.continuous._thread.is_alive()


def test_continuous_admission_control(exported):
    """--serve-max-pending bounds the slot queue: a request with more rows
    than that is refused whole with EngineOverloaded."""
    path, _, _, _ = exported
    service = serve.CaptionService(serve.parse_args(
        ["--checkpoint", path, *FLAGS, "--serve-continuous",
         "--serve-max-pending", "4"]))
    try:
        resp = service.handle_line(json.dumps({"n": 5}))
        assert resp["error"].startswith("EngineOverloaded")
        assert service.continuous.stats()["rejected"] == 5
        assert len(service.handle_request({"n": 4})["captions"]) == 4
    finally:
        service.close()


def test_continuous_default_device_is_cuda_and_never_falls_back(exported):
    path, _, _, _ = exported
    args = serve.parse_args(["--checkpoint", path, *FLAGS[:-2],
                             "--serve-continuous", "--quantize", "int8"])
    assert args.device == "cuda" and args.serve_chunk_steps == 8
    assert args.serve_adaptive_chunk == 0 and not args.serve_exact
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.CaptionService(args)
