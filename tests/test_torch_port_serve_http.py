"""The port's service around the engines, after the JAX package's
``tests/test_serve.py:95-480``, on the CPU at tiny widths (LSTM, E = 12,
H = 16, T = 11): ``{"reload": path}`` on both engines (a failed load or
warm-up leaves the old model serving, the superseded slot engine closes),
``--serve-watch``, the HTTP front end (status codes, ``/stats``,
``/healthz``, ``/metrics``, chunked streaming), ``--port`` beside
``--http-port`` through ``serve.main``, ``--decode-mode speculative`` on
both engines and in ``caption.py``.  The references are services started
on the other checkpoint and the greedy services; logprobs within 1e-4
(float32 sums in another order: the verify pass against the rescoring
stepper).  Every server, watcher and engine a test starts is stopped in
it."""

import http.client
import io
import json
import os
import shutil
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu_torch import caption as tcaption
from gan_image_captioning_tpu_torch import serve
from gan_image_captioning_tpu_torch.serving import EngineOverloaded
from gan_image_captioning_tpu_torch.train.checkpoint import (
    save_generator_checkpoint)

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

BASE = ["--dataset", "synthetic", "--max-seq-len", "9", "--gen-embed-dim",
        "12", "--gen-hidden-dim", "16", "--serve-batch-size", "4",
        "--device", "cpu"]
CONTINUOUS = ["--serve-continuous", "--serve-chunk-steps", "4"]
LP_ATOL = 1e-4


def _service(*argv):
    return serve.CaptionService(serve.parse_args([*argv, *BASE]))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Two checkpoints of seeded weights (seeds 0 and 21) and one of
    another hidden size."""
    d = tmp_path_factory.mktemp("ckpts")
    paths = []
    for seed, extra in ((0, []), (21, []), (3, ["--gen-hidden-dim", "20"])):
        svc = serve.CaptionService(serve.parse_args(
            ["--init-seed", str(seed), *BASE, *extra]))
        try:
            path = str(d / f"gen{len(paths)}.ckpt")
            save_generator_checkpoint(path, svc.generator)
            paths.append(path)
        finally:
            svc.close()
    return paths


@pytest.fixture
def services():
    """Closes every service a test made (engines, watcher)."""
    made = []

    def make(*argv):
        svc = _service(*argv)
        made.append(svc)
        return svc

    yield make
    for svc in made:
        svc.close()
        assert svc.batcher._thread is not None
        assert not svc.batcher._thread.is_alive()


def _want(services, path, n, extra=()):
    return services("--checkpoint", path, *extra).handle_request({"n": n})


# ------------------------------------------------------------------ reload

@pytest.mark.parametrize("engine", ["coalescing", "continuous"])
def test_reload_swaps_the_model(ckpts, services, engine):
    p0, p1, wide = ckpts
    extra = CONTINUOUS if engine == "continuous" else []
    svc = services("--checkpoint", p0, *extra)
    before = svc.handle_request({"n": 3})
    want = _want(services, p1, 3, extra)
    assert want["captions"] != before["captions"]   # distinct inits differ
    old_engine = svc.continuous
    # a failed load (missing file, other geometry) leaves the old model
    with pytest.raises(FileNotFoundError):
        svc.handle_request({"reload": p1 + ".missing"})
    assert "FileNotFoundError" in svc.handle_line(
        json.dumps({"reload": p1 + ".missing"}))["error"]
    with pytest.raises(RuntimeError, match="size mismatch"):
        svc.handle_request({"reload": wide})
    assert svc.handle_request({"n": 3})["captions"] == before["captions"]
    assert svc.continuous is old_engine
    assert svc.handle_request({"stats": True})["checkpoint"] == p0

    resp = svc.handle_request({"reload": p1})
    assert resp["reloaded"] == p1 and resp["latency_ms"] > 0
    after = svc.handle_request({"n": 3})
    assert after["captions"] == want["captions"]
    np.testing.assert_allclose(after["logprobs"], want["logprobs"],
                               atol=LP_ATOL)
    assert svc.handle_request({"stats": True})["checkpoint"] == p1
    if engine == "continuous":
        assert svc.continuous is not old_engine
        assert not old_engine._thread.is_alive()
        with pytest.raises(RuntimeError, match="closed"):
            old_engine.submit(np.zeros(12, np.float32))
        assert svc.handle_request({"stats": True})["coalescing"][
            "rows_dispatched"] == 0          # every caption took a slot


def test_failed_warm_up_leaves_the_old_engine_serving(ckpts, services,
                                                      monkeypatch):
    """The successor is built and warmed over the new weights before the
    swap; when its warm-up fails it is closed and the old engine, model and
    checkpoint path stay."""
    p0, p1, _ = ckpts
    svc = services("--checkpoint", p0, *CONTINUOUS)
    before = svc.handle_request({"n": 2})["captions"]
    old_engine = svc.continuous
    built = []

    class Recording(serve.ContinuousBatcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

        def submit(self, *a, **kw):
            raise RuntimeError("warm-up fault")

    monkeypatch.setattr(serve, "ContinuousBatcher", Recording)
    with pytest.raises(RuntimeError, match="warm-up fault"):
        svc.reload_checkpoint(p1)
    assert len(built) == 1 and not built[0]._thread.is_alive()
    assert svc.continuous is old_engine and old_engine._thread.is_alive()
    assert svc.checkpoint_path == p0
    assert svc.handle_request({"n": 2})["captions"] == before


def test_stdin_reload_lines(ckpts, services, monkeypatch, capsys):
    """``serve.main`` over stdin: a reload line swaps the model, a failed
    one answers an error and the loop goes on."""
    p0, p1, _ = ckpts
    want0 = _want(services, p0, 2)["captions"]
    want1 = _want(services, p1, 2)["captions"]
    lines = [{"n": 2}, {"reload": p1 + ".missing"}, {"n": 2},
             {"reload": p1}, {"n": 2}, {"stats": True}]
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "".join(json.dumps(r) + "\n" for r in lines)))
    serve.main(["--checkpoint", p0, *BASE, *CONTINUOUS])
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert out[0]["status"] == "ready"
    assert out[1]["captions"] == want0 and "error" in out[2]
    assert out[3]["captions"] == want0 and out[4]["reloaded"] == p1
    assert out[5]["captions"] == want1 and out[6]["checkpoint"] == p1


def test_serve_watch_reloads_a_rewritten_checkpoint(ckpts, services,
                                                    tmp_path, capsys):
    """``--serve-watch``: overwriting the serving checkpoint swaps the
    model within a few polls, once the file has held still for two."""
    p0, p1, _ = ckpts
    path = str(tmp_path / "serving.ckpt")
    shutil.copy(p0, path)
    svc = services("--checkpoint", path)
    before = svc.handle_request({"n": 2})["captions"]
    want = _want(services, p1, 2)["captions"]
    svc.start_watch(0.05)
    watcher = svc._watch_thread
    try:
        time.sleep(0.2)                    # no change: no reload
        assert svc.handle_request({"n": 2})["captions"] == before
        shutil.copy(p1, path + ".tmp")
        os.replace(path + ".tmp", path)
        deadline = time.monotonic() + 30
        after = before
        while after == before and time.monotonic() < deadline:
            time.sleep(0.05)
            after = svc.handle_request({"n": 2})["captions"]
    finally:
        svc.stop_watch()
    assert not watcher.is_alive()
    assert after == want
    assert '"watch": true' in capsys.readouterr().out


# -------------------------------------------------------------------- HTTP

@pytest.fixture
def front():
    """``front(service)`` → the base URL of an HTTP front end on an
    ephemeral port; every server is shut down after the test."""
    servers = []

    def start(service):
        srv = serve.make_http_server(service, 0)
        servers.append((srv, threading.Thread(target=srv.serve_forever,
                                              daemon=True)))
        servers[-1][1].start()
        return f"http://127.0.0.1:{srv.server_address[1]}"

    yield start
    for srv, thread in servers:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def _post(url, body):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def test_http_front_end(ckpts, services, front):
    p0, _, _ = ckpts
    svc = services("--checkpoint", p0)
    base = front(svc)
    code, out = _post(base + "/", {"n": 2})
    assert code == 200
    assert out["captions"] == svc.handle_request({"n": 2})["captions"]
    code, _, body = _get(base + "/healthz")
    assert code == 200 and json.loads(body)["status"] == "ok"
    code, _, body = _get(base + "/stats")
    assert code == 200 and json.loads(body)["coalescing"]["requests"] >= 2
    code, ctype, prom = _get(base + "/metrics")
    assert code == 200 and ctype.startswith("text/plain")
    assert 'gic_serving_requests{engine="coalescing"}' in prom
    assert 'gic_serving_rejected{engine="coalescing"} 0' in prom
    assert _post(base + "/", b"{nope")[0] == 400            # malformed
    assert _post(base + "/", b"[1, 2]")[0] == 400           # not an object
    code, out = _post(base + "/", {"n": 0})                 # an error answer
    assert code == 400 and "error" in out
    assert _post(base + "/", {"stream": True, "n": 1})[0] == 400
    assert _get(base + "/nowhere")[0] == 404
    assert _post(base + "/nowhere", {"n": 1})[0] == 404


def test_http_error_codes(ckpts, services, front, monkeypatch):
    """A server-side fault is 500, a full queue 503; a GET whose handler
    raises answers 500 instead of dropping the connection."""
    p0, _, _ = ckpts
    svc = services("--checkpoint", p0)
    base = front(svc)

    def fault(exc):
        def handle(req, emit=None):
            raise exc
        return handle

    monkeypatch.setattr(svc, "handle_request",
                        fault(RuntimeError("engine fault")))
    code, out = _post(base + "/", {"n": 1})
    assert code == 500 and "engine fault" in out["error"]
    assert _get(base + "/stats")[0] == 500
    assert _post(base + "/", {"n": 1, "stream": True})[0] == 500
    monkeypatch.setattr(svc, "handle_request",
                        fault(EngineOverloaded("queue at max_pending")))
    assert _post(base + "/", {"n": 1})[0] == 503
    assert _post(base + "/", {"n": 1, "stream": True})[0] == 503


def test_http_streaming_chunked(ckpts, services, front):
    """``{"stream": true}`` over HTTP on the continuous engine: chunked
    NDJSON, one ``{"row", "partial", "done"}`` line per committed chunk,
    then the response; each row's last partial is its caption."""
    p0, _, _ = ckpts
    svc = services("--checkpoint", p0, "--serve-continuous",
                   "--serve-chunk-steps", "2")
    base = front(svc)
    host, port = base[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request("POST", "/", body=json.dumps({"n": 2, "stream": True}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Transfer-Encoding") == "chunked"
        assert resp.getheader("Content-Type") == "application/x-ndjson"
        lines = [json.loads(ln) for ln in resp.read().decode().splitlines()]
    finally:
        conn.close()
    final = lines[-1]
    stream = lines[:-1]
    assert len(final["captions"]) == 2 and len(stream) >= 2
    for j in range(2):
        rows = [ln for ln in stream if ln["row"] == j]
        assert rows and rows[-1]["done"] is True
        assert all(not ln["done"] for ln in rows[:-1])
        assert rows[-1]["partial"] == final["captions"][j]
    code, out = _post(base + "/", {"n": 2})         # non-stream unaffected
    assert code == 200 and out["captions"] == final["captions"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_main_runs_tcp_and_http_together(ckpts, monkeypatch):
    """``serve.main --port P --http-port Q``: both front ends over one
    service; shutting the foreground server ends ``main``, which stops the
    other server and closes the service."""
    p0, _, _ = ckpts
    made, services_made = [], []
    for name in ("make_http_server", "make_tcp_server"):
        real = getattr(serve, name)
        monkeypatch.setattr(serve, name, lambda s, p, real=real: made.append(
            real(s, p)) or made[-1])
    real_service = serve.CaptionService

    def service(args):
        services_made.append(real_service(args))
        return services_made[-1]

    monkeypatch.setattr(serve, "CaptionService", service)
    tcp_port, http_port = _free_port(), _free_port()
    main = threading.Thread(target=serve.main, args=(
        ["--checkpoint", p0, *BASE, "--port", str(tcp_port),
         "--http-port", str(http_port)],), daemon=True)
    main.start()
    try:
        deadline = time.monotonic() + 60
        while len(made) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(made) == 2
        with socket.create_connection(("127.0.0.1", tcp_port), 30) as s:
            s.sendall(b'{"n": 1}\n')
            with s.makefile() as f:
                tcp_out = json.loads(f.readline())
        code, http_out = _post(f"http://127.0.0.1:{http_port}/", {"n": 1})
        assert code == 200 and http_out["captions"] == tcp_out["captions"]
        assert len(tcp_out["captions"]) == 1
    finally:
        if len(made) == 2:
            made[-1].shutdown()            # the foreground server
        main.join(timeout=30)
    assert not main.is_alive()
    svc = services_made[0]
    assert not svc.batcher._thread.is_alive()


# ------------------------------------------------------------- speculative

@pytest.mark.parametrize("engine", ["coalescing", "continuous"])
def test_speculative_service_matches_greedy(ckpts, services, engine):
    """``--decode-mode speculative --draft-len 3`` serves the greedy
    service's captions (the int8 twin drafts, the model verifies)."""
    p0, _, _ = ckpts
    extra = ["--serve-continuous"] if engine == "continuous" else []
    want = _want(services, p0, 4)
    svc = services("--checkpoint", p0, "--decode-mode", "speculative",
                   "--draft-len", "3", *extra)
    assert svc.mode == "speculative" and svc.args.draft_len == 3
    assert svc.dec_params is not svc.generator      # the quantized draft
    got = svc.handle_request({"n": 4})
    assert got["captions"] == want["captions"]
    np.testing.assert_allclose(got["logprobs"], want["logprobs"],
                               atol=LP_ATOL)
    st = svc.handle_request({"stats": True})
    if engine == "continuous":
        assert st["coalescing"]["rows_dispatched"] == 0
        assert 1.0 <= st["continuous"]["tokens_per_slot_chunk"] <= 4.0
    else:
        assert st["coalescing"]["device_calls"] >= 2


@pytest.mark.parametrize("extra", [[], ["--serve-continuous"]])
def test_speculative_refuses_a_transformer(extra):
    with pytest.raises(SystemExit, match="LSTM"):
        serve.CaptionService(serve.parse_args(
            ["--init-seed", "0", *BASE, "--gen-arch", "transformer",
             "--gen-num-heads", "2", "--decode-mode", "speculative",
             *extra]))


def test_caption_speculative_matches_greedy(ckpts, tmp_path):
    """``caption.py --decode-mode speculative --draft-len 3`` writes the
    greedy captions and logprobs; a transformer checkpoint is refused."""
    p0, _, _ = ckpts
    flags = ["--checkpoint", p0, *BASE[:-4], *BASE[-2:], "--num-samples",
             "6"]
    out = {}
    for mode in ("greedy", "speculative"):
        path = str(tmp_path / f"{mode}.jsonl")
        ids = tcaption.main([*flags, "--decode-mode", mode, "--draft-len",
                             "3", "--output", path])
        out[mode] = ([json.loads(ln) for ln in open(path)], np.stack(ids))
    (want, want_ids), (got, got_ids) = out["greedy"], out["speculative"]
    assert len(got) == 6
    np.testing.assert_array_equal(got_ids, want_ids)
    assert [r["caption"] for r in got] == [r["caption"] for r in want]
    np.testing.assert_allclose([r["logprob"] for r in got],
                               [r["logprob"] for r in want], atol=LP_ATOL)
    with pytest.raises(SystemExit, match="LSTM"):
        tcaption.main([*flags, "--gen-arch", "transformer",
                       "--gen-num-heads", "2", "--decode-mode",
                       "speculative"])
