"""Caption serving entry point (the PyTorch port of ``src/serve.py``).

Requests arrive as JSON lines (stdin, or TCP with ``--port``) and are
answered as JSON lines.  Two engines (``serving.py``):

* by default one dispatcher
  (:class:`~gan_image_captioning_tpu_torch.serving.CoalescingBatcher`)
  coalesces requests into fixed-shape decode batches: greedy, each one
  call of the serve-mode decode kernel on the card
  (``--serve-adaptive-chunk K``: K-step chunks of the carried-state kernel
  until every row has emitted ``<E>``); beam search
  (``--decode-mode beam``, or ``auto`` with ``--beam-size`` above 1;
  ``--length-penalty``, ``--min-length``); or sampling (``--decode-mode
  sample`` with ``--top-k``, ``--top-p``, ``--sample-temperature``,
  ``--repetition-penalty``, ``--no-repeat-ngram``, ``--min-length``), its
  noise from a ``torch.Generator`` seeded by (``--sample-seed``, the
  dispatcher's call index), and ended rows stop early unless
  ``--serve-exact``;
* ``--serve-continuous``: a pool of ``--serve-batch-size`` decode slots
  (:class:`~gan_image_captioning_tpu_torch.serving.ContinuousBatcher`)
  advances ``--serve-chunk-steps`` tokens per call of the carried-state
  kernel, and requests join it at chunk boundaries.  A slot frees at the
  first chunk with ``<E>`` (the tail is ``<PAD>``) unless ``--serve-exact``.
  It decodes greedily: with beam search or sampling the coalescing
  engine serves, as in the JAX package.

``--quantize int8|int4`` serves the quantized decoder (``ops/quantize.py``)
through the quantized serve kernel in either engine.  A transformer
generator (``--gen-arch transformer``, e.g. ``--preset config4``) is served
by the coalescing engine through its KV-cache greedy decode; the continuous
engine, the adaptive decode and ``--quantize`` refuse it.  A conditional
transformer (``--preset config5``, or ``--gen-arch transformer
--conditional-gan 1``) decodes an image request over the encoder's grid:
each row the engine carries is the features and the flattened grid
together, so ``serve.py`` and ``caption.py`` give one image the same
caption (``src/serve.py`` passes only the features).  ``--tokenizer bpe``
reads the vocabulary size from ``--bpe-vocab`` and writes the captions
through the BPE decoder.  A warm request runs
at startup, so the first client request finds the kernel built and loaded.

    # a checkpoint in the reference state_dict layout (src/export_torch.py
    # writes one from a JAX checkpoint):
    printf '{"n": 3}\\n{"stats": true}\\n' | python -m gan_image_captioning_tpu_torch.serve \\
        --checkpoint gen.ckpt --dataset synthetic --vocab-multiple 11008 \\
        --gen-embed-dim 512 --gen-hidden-dim 512 --gen-num-layers 2

    # or a seeded start with random weights:
    python -m gan_image_captioning_tpu_torch.serve --init-seed 0 --dataset synthetic --port 7777

    # conditional: captions of images (a checkpoint of main.py's run on
    # data/mini_coco, here on the CPU):
    printf '{"image": "data/mini_coco/val2014/mini_val_0000.jpg"}\\n' | \\
        python -m gan_image_captioning_tpu_torch.serve --checkpoint \\
        save/debug_1/models/pretrained_model.ckpt --dataset coco \\
        --data-dir data/mini_coco --conditional-gan 1 --device cpu …

    # continuous batching on int8 weights, streaming one request:
    printf '{"n": 2, "stream": true}\\n' | python -m gan_image_captioning_tpu_torch.serve \\
        --init-seed 0 --dataset synthetic --serve-continuous --quantize int8

Request forms:
  {"n": k}                  → k captions from the <S>-token features
  {"image": path | [paths]} → (conditional service) one caption per image:
                              host decode and normalize (Pillow), one
                              eval-mode encoder pass on the device, then
                              the rows enter the engine like {"n": k} rows
  {"n": k, "stream": true}  → (--serve-continuous) first one
                              {"row": j, "partial": "...", "done": bool}
                              line per chunk that commits tokens, then the
                              response
  {"stats": true}           → engine counters ("coalescing", and
                              "continuous" when that engine runs)
Response: {"captions": [...], "logprobs": [...], "latency_ms": t}

The service runs on ``--device cuda`` (the default) and raises when CUDA
is missing; ``--device cpu`` runs the plain PyTorch decode.  Every flag of
``src/serve.py`` parses; not ported, and raising when set: ``--decode-mode
speculative`` and ``--draft-len``, HTTP, ``--exported``, ``--serve-watch``
(and ``{"reload"}``), ``--mesh``.
"""

from __future__ import annotations

import json
import os
import queue
import socketserver
import sys
import time

import numpy as np
import torch

from gan_image_captioning_tpu_torch.config import (build_parser,
                                                   config_from_args,
                                                   padded_vocab_size,
                                                   refuse_unported,
                                                   require_ported_flags,
                                                   resolve_device)
from gan_image_captioning_tpu_torch.data.synthetic import synthetic_vocab
from gan_image_captioning_tpu_torch.eval import decode as decode_lib
from gan_image_captioning_tpu_torch.eval.metrics import caption_text
from gan_image_captioning_tpu_torch.models.encoder import grid_shape
from gan_image_captioning_tpu_torch.models.api import (generator_condition,
                                                       init_generator,
                                                       require_ported,
                                                       start_token_features)
from gan_image_captioning_tpu_torch.ops.quantize import quantize_generator
from gan_image_captioning_tpu_torch.serving import (CoalescingBatcher,
                                                    ContinuousBatcher)
from gan_image_captioning_tpu_torch.train import checkpoint as ckpt_lib


# the flags of src/serve.py the port does not honour yet, as the training
# flags' table in config.py: (flag, argparse keywords with the JAX name,
# type and default, the values the port honours or None for the default)
_UNPORTED_SERVE_ARGS = (
    ("--exported", dict(type=str, default=""), None),
    ("--http-port", dict(type=int, default=0), None),
    ("--serve-watch", dict(type=float, default=0.0), None),
    ("--decode-mode", dict(type=str, default="auto",
                           choices=["auto", "greedy", "beam", "sample",
                                    "speculative"]),
     ("auto", "greedy", "beam", "sample")),
    ("--draft-len", dict(type=int, default=4), None),
)


def add_sampling_args(parser):
    """The sampled decode's knobs (``src/serve.py`` and ``src/caption.py``
    name them alike)."""
    parser.add_argument("--top-k", type=int, default=0,
                        help="sample mode: keep only the k highest-"
                             "probability tokens per step (0 = no top-k "
                             "filter)")
    parser.add_argument("--top-p", type=float, default=1.0,
                        help="sample mode: nucleus filtering, keep the "
                             "smallest token prefix whose probability mass "
                             "reaches p (1.0 = off)")
    parser.add_argument("--sample-temperature", type=float, default=1.0,
                        help="sample mode: softmax temperature (<1 sharpens, "
                             ">1 flattens)")
    parser.add_argument("--repetition-penalty", type=float, default=1.0,
                        help="sample mode: CTRL-style penalty on already-"
                             "emitted tokens (>1; with --top-k 1 this is "
                             "penalized greedy)")
    parser.add_argument("--no-repeat-ngram", type=int, default=0,
                        choices=[0, 2, 3],
                        help="sample mode: forbid completing an n-gram the "
                             "caption already contains")
    parser.add_argument("--min-length", type=int, default=0,
                        help="beam/sample modes: forbid <E> until this many "
                             "tokens stand (selection only)")
    parser.add_argument("--sample-seed", type=int, default=0,
                        help="sample mode: the seed of the noise generator")


def decode_mode(args, config) -> str:
    """``--decode-mode`` with ``auto`` resolved: beam when
    ``--beam-size`` is above 1, else greedy."""
    mode = args.decode_mode
    if mode == "auto":
        mode = "beam" if config.beam_size > 1 else "greedy"
    return mode


def sample_generator(seed: int, call: int, device) -> torch.Generator:
    """The noise generator of the ``call``-th sampled decode under
    ``--sample-seed seed``: deterministic per (seed, call), as the JAX
    package folds its call count into its base key."""
    state = np.random.SeedSequence([seed, call]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 32 | int(state[1]))


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
    parser.add_argument("--serve-continuous", action="store_true",
                        help="slot-based continuous batching: requests join "
                             "the decode pool at chunk boundaries instead "
                             "of waiting for whole batches (greedy only: "
                             "beam search and sampling take the coalescing "
                             "engine)")
    parser.add_argument("--serve-chunk-steps", type=int, default=8,
                        help="decode steps per device call in "
                             "--serve-continuous mode")
    parser.add_argument("--serve-exact", action="store_true",
                        help="--serve-continuous: no early slot release, so "
                             "ids equal the full-T batch greedy decode (by "
                             "default a slot frees at the first chunk with "
                             "<E> and the tail is <PAD>); sample mode: no "
                             "early stop")
    parser.add_argument("--serve-adaptive-chunk", type=int, default=0,
                        help="coalescing decode in K-step chunks that stop "
                             "once every row has emitted <E> (0 = the full "
                             "T-step decode); the tail after <E> is <PAD>")
    add_sampling_args(parser)
    for flag, kw, honoured in _UNPORTED_SERVE_ARGS:
        parser.add_argument(flag, **kw, help=(
            f"honours {', '.join(honoured)}; the rest raises" if honoured
            else "not ported yet: raises when set"))
    args = parser.parse_args(argv)
    refuse_unported(_UNPORTED_SERVE_ARGS, args)
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


def build_vocab(args):
    """The dataset's ``index_to_word`` (a ``BPETokenizer`` under
    ``--tokenizer bpe`` on COCO); sets ``args.vocab_size`` with the
    ``--vocab-multiple`` padding (``src/main.py:inject_vocab_size``).  COCO
    reads the train split's vocabulary (the pickle cache under
    ``--data-dir``)."""
    if args.dataset == "synthetic":
        w2i, i2w = synthetic_vocab()
        args.vocab_size = padded_vocab_size(len(w2i), args.vocab_multiple)
        return i2w
    if args.tokenizer == "bpe":
        from gan_image_captioning_tpu_torch.data.bpe import BPETokenizer

        tok = BPETokenizer(args.bpe_vocab, args.bpe_merges)
        args.vocab_size = padded_vocab_size(tok.vocab_size,
                                            args.vocab_multiple)
        return tok
    from gan_image_captioning_tpu_torch.data.coco import CocoCaptions

    train = CocoCaptions(os.path.join(args.data_dir, "dataset_coco.json"),
                         args.data_dir, "train", args.image_size,
                         args.captions_per_image, conditional=False)
    args.vocab_size = padded_vocab_size(train.vocab_size, args.vocab_multiple)
    return train.index_to_word


class CaptionService:
    def __init__(self, args):
        for check in (require_ported_flags, require_ported):
            check(config_from_args(args))
        self.device = resolve_device(args.device)
        self.index_to_word = build_vocab(args)
        self.config = config_from_args(args)
        self.batch_size = args.serve_batch_size
        if args.checkpoint:
            generator, _ = ckpt_lib.load_generator_checkpoint(
                args.checkpoint, self.config, self.device)
            self.checkpoint_path = args.checkpoint
        else:
            rng = torch.Generator().manual_seed(args.init_seed)
            generator = init_generator(rng, self.config, self.device,
                                       sweep=args.init_sweep)
            self.checkpoint_path = f"init-seed:{args.init_seed}"
        self.generator = generator.requires_grad_(False)
        # the decode reads the quantized twin under --quantize; the start
        # token's feature row stays the full-precision embedding
        self.dec_params = (quantize_generator(self.generator, self.config)
                           if self.config.quantize != "none"
                           else self.generator)
        self.adaptive_chunk = int(args.serve_adaptive_chunk)
        self.mode = decode_mode(args, self.config)
        self.args = args
        self.sample_calls = 0        # read and advanced by the dispatcher
        self.continuous = None
        # a conditional transformer's rows: features, then the grid [P, C]
        self.context_shape = (
            grid_shape(self.config) if self.config.cgan
            and self.config.gen_arch == "transformer" else None)
        row_dim = self.config.gen_embed_dim + (
            0 if self.context_shape is None else int(np.prod(
                self.context_shape)))
        self.batcher = CoalescingBatcher(
            self._run_decode, self.batch_size, row_dim,
            bucket_sizes=_parse_buckets(args.serve_buckets, self.batch_size),
            max_pending=args.serve_max_pending)
        try:
            if (args.serve_continuous and self.config.beam_size == 1
                    and self.mode != "sample"):
                self.continuous = ContinuousBatcher(
                    self.dec_params, self.config, num_slots=self.batch_size,
                    chunk_steps=args.serve_chunk_steps,
                    early_exit=not args.serve_exact,
                    max_pending=args.serve_max_pending)
            # warm through the real request path, every bucket shape (the
            # slot pool has one shape), and the encoder at one image
            self._warm(1)
            if self.config.cgan:
                s = self.config.image_size
                self.features_from_images(np.zeros((1, 3, s, s), np.float32))
            if self.continuous is None:
                for b in self.batcher.bucket_sizes[1:]:
                    self._warm(b)
        except BaseException:
            self.close()
            raise

    def _warm(self, n: int) -> None:
        """A request of n rows: ``{"n": n}``, or n blank images for a
        conditional transformer (its rows carry a grid)."""
        if self.context_shape is None:
            self.handle_request({"n": n})
        else:
            s = self.config.image_size
            self.caption_images(np.zeros((n, 3, s, s), np.float32))

    def _run_decode(self, feats: np.ndarray):
        """One dispatched batch → ``(ids, seq_logprob)`` on the device.
        A conditional transformer's rows are split into the features and
        the grid, its ``context``."""
        x = torch.from_numpy(np.ascontiguousarray(feats)).to(self.device)
        ctx = None
        if self.context_shape is not None:
            E = self.config.gen_embed_dim
            x, ctx = x[:, :E], x[:, E:].reshape(-1, *self.context_shape)
        a = self.args
        if self.mode == "sample":
            rng = sample_generator(a.sample_seed, self.sample_calls,
                                   self.device)
            self.sample_calls += 1
            return decode_lib.sample_decode(
                self.dec_params, x, self.config, rng,
                temperature=a.sample_temperature, top_k=a.top_k,
                top_p=a.top_p, early_stop=not a.serve_exact,
                repetition_penalty=a.repetition_penalty,
                no_repeat_ngram=a.no_repeat_ngram, min_length=a.min_length,
                context=ctx)
        if self.config.beam_size > 1:
            return decode_lib.beam_search(
                self.dec_params, x, self.config,
                beam_size=self.config.beam_size,
                length_penalty=self.config.length_penalty,
                min_length=a.min_length, context=ctx)
        if self.adaptive_chunk > 0:
            return decode_lib.greedy_with_logprobs_adaptive(
                self.dec_params, x, self.config, chunk=self.adaptive_chunk)
        return decode_lib.greedy_with_logprobs(self.dec_params, x,
                                               self.config, context=ctx)

    def _features_unconditional(self, n: int) -> np.ndarray:
        return start_token_features(self.config, self.generator,
                                    n).cpu().numpy()

    @torch.no_grad()
    def features_from_images(self, images: np.ndarray) -> np.ndarray:
        """The device part of an image request: normalized ``[N, 3, S, S]``
        float32 images → ``[N, E]`` features from one eval-mode encoder
        pass (``generator_condition(train=False)``); a conditional
        transformer's rows are ``[N, E + P·C]``, the features and the
        flattened grid."""
        batch = {"images": torch.from_numpy(
            np.ascontiguousarray(images, np.float32)).to(self.device)}
        cond, _ = generator_condition(self.config, self.generator, batch,
                                      train=False)
        rows = cond["features"]
        if self.context_shape is not None:
            rows = torch.cat([rows, cond["context"].flatten(1)], dim=1)
        return rows.cpu().numpy()

    def _load_images(self, paths) -> np.ndarray:
        """The host part of an image request: decode, resize and normalize
        each file (``data/images.py``, Pillow) → ``[N, 3, S, S]``."""
        from gan_image_captioning_tpu_torch.data.images import (
            load_and_preprocess)

        return np.stack([load_and_preprocess(p, self.config.image_size)
                         for p in paths])

    def _caption(self, ids) -> str:
        return caption_text(ids, self.index_to_word)

    def handle_request(self, req: dict, emit=None) -> dict:
        """One request → one response dict.

        ``emit`` (optional): a callable the line transports pass so that
        ``{"stream": true}`` on a ``--serve-continuous`` service sends an
        intermediate ``{"row": j, "partial": "<caption so far>", "done":
        bool}`` line for every chunk that commits tokens for the request,
        before the response."""
        t0 = time.perf_counter()
        if req.get("stats"):
            out = {"coalescing": self.batcher.stats(),
                   "checkpoint": self.checkpoint_path}
            if self.continuous is not None:
                out["continuous"] = self.continuous.stats()
            return out
        if "image" in req:
            if not self.config.cgan:
                return {"error": "checkpoint is unconditional; use {'n': k}"}
            paths = req["image"]
            if isinstance(paths, str):
                paths = [paths]
            if not paths:
                return {"error": "'image' must be a path or non-empty list"}
            n = len(paths)
        else:
            if self.context_shape is not None:
                return {"error": "a conditional transformer captions "
                                 "images: use {'image': path}"}
            paths = None
            n = int(req.get("n", 1))
            if n < 1:
                return {"error": "'n' must be a positive integer"}
        stream = bool(req.get("stream"))
        if stream and (self.continuous is None or emit is None):
            return {"error": "streaming needs --serve-continuous (and a "
                             "streaming transport: stdin or --port TCP)"}
        if paths is not None:
            return self.caption_images(self._load_images(list(paths)),
                                       emit if stream else None, t0)
        return self._respond(self._features_unconditional(n),
                             emit if stream else None, t0)

    def caption_images(self, images: np.ndarray, emit=None,
                       t0: float = None) -> dict:
        """The device part of an image request: normalized ``[N, 3, S, S]``
        float32 images → one eval-mode encoder pass → the rows enter the
        engine like ``{"n": k}`` rows → the response."""
        t0 = time.perf_counter() if t0 is None else t0
        return self._respond(self.features_from_images(images), emit, t0)

    def _respond(self, feats: np.ndarray, emit, t0: float) -> dict:
        if self.continuous is not None:
            ids, lps = self._continuous(feats, emit)
        else:
            ids, lps = self.batcher.submit(feats).result(timeout=120)
        return {"captions": [self._caption(row) for row in ids],
                "logprobs": [round(float(x), 4) for x in lps],
                "latency_ms": round((time.perf_counter() - t0) * 1e3, 2)}

    def _continuous(self, feats: np.ndarray, emit):
        """Each row takes a decode slot (the whole request is admitted or
        rejected at once); with ``emit``, chunk progress is relayed until
        every row has resolved."""
        events = queue.Queue() if emit is not None else None
        on_tokens = (None if events is None else
                     (lambda j, ids, done: events.put((j, ids, done))))
        futs = self.continuous.submit_many(list(feats), on_tokens=on_tokens)
        if events is not None:
            def relay(ev):
                j, ids_now, done = ev
                emit({"row": j, "partial": self._caption(ids_now),
                      "done": bool(done)})

            deadline = time.monotonic() + 120
            while (any(not f.done() for f in futs)
                   and time.monotonic() < deadline):
                try:
                    relay(events.get(timeout=0.1))
                except queue.Empty:
                    pass
            while not events.empty():    # what landed after the last future
                relay(events.get_nowait())
        results = [f.result(timeout=120) for f in futs]
        return (np.stack([r[0] for r in results]),
                np.asarray([r[1] for r in results]))

    def handle_line(self, line: str, emit=None) -> dict:
        """A request line → its response; a malformed request or a failed
        decode answers with an error instead of ending the loop."""
        try:
            return self.handle_request(json.loads(line), emit=emit)
        except Exception as exc:  # the serving loop must keep running
            return {"error": f"{type(exc).__name__}: {exc}"}

    def close(self):
        if self.continuous is not None:
            self.continuous.close()
        self.batcher.close()


def make_tcp_server(service: CaptionService, port: int):
    """JSON-lines TCP front end on 127.0.0.1 over the same dispatcher."""
    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            def emit(obj):
                self.wfile.write((json.dumps(obj) + "\n").encode())
                self.wfile.flush()

            for line in self.rfile:
                if line.strip():
                    emit(service.handle_line(line.decode(), emit=emit))

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
            def emit(obj):
                print(json.dumps(obj), flush=True)

            for line in sys.stdin:
                if line.strip():
                    emit(service.handle_line(line, emit=emit))
    finally:
        service.close()


if __name__ == "__main__":
    main()
