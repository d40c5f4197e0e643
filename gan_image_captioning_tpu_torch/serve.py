"""Caption serving entry point (the PyTorch port of ``src/serve.py``).

Requests arrive as JSON lines (stdin, or TCP with ``--port``), coalesce in
one dispatcher (:class:`~gan_image_captioning_tpu_torch.serving.CoalescingBatcher`)
into fixed-shape greedy decode batches, and are answered as JSON lines.
On the card each batch is one call of the serve-mode decode kernel.  A warm
request runs at startup, so the first client request finds the kernel
built and loaded.

    # a checkpoint in the reference state_dict layout (src/export_torch.py
    # writes one from a JAX checkpoint):
    printf '{"n": 3}\\n{"stats": true}\\n' | python -m gan_image_captioning_tpu_torch.serve \\
        --checkpoint gen.ckpt --dataset synthetic --vocab-multiple 11008 \\
        --gen-embed-dim 512 --gen-hidden-dim 512 --gen-num-layers 2

    # or a seeded start with random weights:
    python -m gan_image_captioning_tpu_torch.serve --init-seed 0 --dataset synthetic --port 7777

Request forms:
  {"n": k}         → k unconditional captions
  {"stats": true}  → dispatcher counters
  {"image": …}     → an error: only unconditional serving is ported
Response: {"captions": [...], "logprobs": [...], "latency_ms": t}

The service runs on ``--device cuda`` (the default) and raises when CUDA
is missing; ``--device cpu`` runs the plain PyTorch decode.
"""

from __future__ import annotations

import json
import socketserver
import sys
import time

import numpy as np
import torch

from gan_image_captioning_tpu_torch.config import (build_parser,
                                                   config_from_args,
                                                   padded_vocab_size,
                                                   resolve_device)
from gan_image_captioning_tpu_torch.data.synthetic import synthetic_vocab
from gan_image_captioning_tpu_torch.eval import decode as decode_lib
from gan_image_captioning_tpu_torch.eval.metrics import (ids_to_words,
                                                         strip_caption)
from gan_image_captioning_tpu_torch.models.api import require_ported
from gan_image_captioning_tpu_torch.models.generator import (
    init_generator_params, start_token_features)
from gan_image_captioning_tpu_torch.serving import CoalescingBatcher
from gan_image_captioning_tpu_torch.train import checkpoint as ckpt_lib


def parse_args(argv=None):
    parser = build_parser()
    parser.add_argument("--checkpoint", type=str, default="",
                        help="generator checkpoint in the reference "
                             "state_dict layout")
    parser.add_argument("--init-seed", type=int, default=None,
                        help="serve random weights drawn from this seed "
                             "instead of a checkpoint")
    parser.add_argument("--init-sweep", action="store_true",
                        help="with --init-seed: apply the --gen-init sweep "
                             "over every weight, as a fresh training run "
                             "does (off: the un-swept initial weights)")
    parser.add_argument("--port", type=int, default=0,
                        help="TCP port on 127.0.0.1 (0 = stdin/stdout loop)")
    parser.add_argument("--serve-batch-size", type=int, default=8)
    parser.add_argument("--serve-buckets", type=str, default="",
                        help="coalescing batch-shape buckets: 'auto' = "
                             "powers of two up to --serve-batch-size, or a "
                             "comma list (e.g. '1,4')")
    parser.add_argument("--serve-max-pending", type=int, default=0,
                        help="reject a request at once when the pending "
                             "queue holds this many entries (0 = unbounded)")
    args = parser.parse_args(argv)
    if bool(args.checkpoint) == (args.init_seed is not None):
        parser.error("exactly one of --checkpoint or --init-seed is required")
    return args


def _parse_buckets(spec: str, batch_size: int):
    """--serve-buckets: 'auto' = powers of two below batch_size, or an
    explicit comma list; None when unset."""
    if spec == "auto":
        buckets, b = [], 1
        while b < batch_size:
            buckets.append(b)
            b *= 2
        return buckets
    if spec:
        return [int(x) for x in spec.split(",")]
    return None


def build_vocab(args) -> dict:
    """The dataset's ``index_to_word``; sets ``args.vocab_size`` with the
    ``--vocab-multiple`` padding (``src/main.py:inject_vocab_size``)."""
    if args.dataset != "synthetic":
        raise NotImplementedError(
            f"--dataset {args.dataset}: only the synthetic vocabulary is "
            "ported yet")
    w2i, i2w = synthetic_vocab()
    args.vocab_size = padded_vocab_size(len(w2i), args.vocab_multiple)
    return i2w


class CaptionService:
    def __init__(self, args):
        self.index_to_word = build_vocab(args)
        self.config = config_from_args(args)
        require_ported(self.config)
        self.device = resolve_device(args.device)
        self.batch_size = args.serve_batch_size
        if args.checkpoint:
            generator, _ = ckpt_lib.load_generator_checkpoint(
                args.checkpoint, self.config, self.device)
            self.checkpoint_path = args.checkpoint
        else:
            rng = torch.Generator().manual_seed(args.init_seed)
            generator = init_generator_params(rng, self.config, self.device,
                                              sweep=args.init_sweep)
            self.checkpoint_path = f"init-seed:{args.init_seed}"
        self.generator = generator.requires_grad_(False)
        self.batcher = CoalescingBatcher(
            self._run_decode, self.batch_size, self.config.gen_embed_dim,
            bucket_sizes=_parse_buckets(args.serve_buckets, self.batch_size),
            max_pending=args.serve_max_pending)
        try:
            # warm through the real request path, every bucket shape
            self.handle_request({"n": 1})
            for b in self.batcher.bucket_sizes[1:]:
                self.handle_request({"n": b})
        except BaseException:
            self.close()
            raise

    def _run_decode(self, feats: np.ndarray):
        """One dispatched batch → ``(ids, seq_logprob)`` on the device."""
        x = torch.from_numpy(np.ascontiguousarray(feats)).to(self.device)
        return decode_lib.greedy_with_logprobs(self.generator, x, self.config)

    def _features_unconditional(self, n: int) -> np.ndarray:
        return start_token_features(self.generator.decoder, n).cpu().numpy()

    def handle_request(self, req: dict) -> dict:
        """One request → one response dict."""
        t0 = time.perf_counter()
        if req.get("stats"):
            return {"coalescing": self.batcher.stats(),
                    "checkpoint": self.checkpoint_path}
        if "image" in req:
            return {"error": "checkpoint is unconditional; use {'n': k}"}
        n = int(req.get("n", 1))
        if n < 1:
            return {"error": "'n' must be a positive integer"}
        feats = self._features_unconditional(n)
        ids, lps = self.batcher.submit(feats).result(timeout=120)
        captions = [" ".join(ids_to_words(strip_caption(row),
                                          self.index_to_word))
                    for row in ids]
        return {"captions": captions,
                "logprobs": [round(float(x), 4) for x in lps],
                "latency_ms": round((time.perf_counter() - t0) * 1e3, 2)}

    def handle_line(self, line: str) -> dict:
        """A request line → its response; a malformed request or a failed
        decode answers with an error instead of ending the loop."""
        try:
            return self.handle_request(json.loads(line))
        except Exception as exc:  # the serving loop must keep running
            return {"error": f"{type(exc).__name__}: {exc}"}

    def close(self):
        self.batcher.close()


def make_tcp_server(service: CaptionService, port: int):
    """JSON-lines TCP front end on 127.0.0.1 over the same dispatcher."""
    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for line in self.rfile:
                if not line.strip():
                    continue
                resp = service.handle_line(line.decode())
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()

    return socketserver.ThreadingTCPServer(("127.0.0.1", port), Handler)


def main(argv=None):
    args = parse_args(argv)
    service = CaptionService(args)
    try:
        print(json.dumps({"status": "ready",
                          "vocab_size": service.config.vocab_size,
                          "device": str(service.device)}), flush=True)
        if args.port:
            with make_tcp_server(service, args.port) as srv:
                srv.serve_forever()
        else:
            for line in sys.stdin:
                if line.strip():
                    print(json.dumps(service.handle_line(line)), flush=True)
    finally:
        service.close()


if __name__ == "__main__":
    main()
