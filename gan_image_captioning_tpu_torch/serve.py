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
generator (``--gen-arch transformer``, e.g. ``--preset config4``) decodes
through its KV-cache stepper on either engine (continuous: a cache and a
position per slot), adaptively under ``--serve-adaptive-chunk``, and
``--quantize`` fake-quantizes its weights.  A conditional
transformer (``--preset config5``, or ``--gen-arch transformer
--conditional-gan 1``) decodes an image request over the encoder's grid:
each row an engine carries (a coalescing batch row or a slot) is the
features and the flattened grid together, so ``serve.py`` and
``caption.py`` give one image the same caption (``src/serve.py`` passes
only the features).

``--decode-mode speculative`` (LSTM only, as in the JAX package) serves
the target's greedy captions through ``eval/speculative.py``: the
quantized twin (int8 unless ``--quantize int4``) drafts ``--draft-len``
tokens a block, the full-precision model verifies them; on the coalescing
engine one ``speculative_greedy`` call a batch (stopping once every row
has ended unless ``--serve-exact``) and the logprobs of a rescoring pass,
on the continuous engine speculative slots.

``{"reload": path}`` swaps in another checkpoint of the same geometry
without downtime (:meth:`CaptionService.reload_checkpoint`); a failed
load, build or warm-up leaves the old model serving.  ``--serve-watch S``
polls the serving checkpoint every S seconds and reloads it once its
size and modification time have held still for two polls.  ``--http-port``
serves ``POST /`` (a request body), ``GET /stats``, ``/healthz`` and
``/metrics`` (Prometheus text) beside ``--port``'s JSON lines and stdin
(:func:`make_http_server`).  ``--tokenizer bpe``
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
  {"reload": path}          → swap to another checkpoint, zero downtime
  {"image": path | [paths]} → (conditional service) one caption per image:
                              host decode and normalize (Pillow), one
                              eval-mode encoder pass on the device, then
                              the rows enter the engine like {"n": k} rows
  {"n": k, "stream": true}  → (--serve-continuous) first one
                              {"row": j, "partial": "...", "done": bool}
                              line per chunk that commits tokens, then the
                              response (over HTTP as chunked NDJSON)
  {"stats": true}           → engine counters ("coalescing", and
                              "continuous" when that engine runs)
Response: {"captions": [...], "logprobs": [...], "latency_ms": t}

The service runs on ``--device cuda`` (the default) and raises when CUDA
is missing; ``--device cpu`` runs the plain PyTorch decode.  Every flag of
``src/serve.py`` parses; not ported, and raising when set: ``--exported``
and ``--mesh``.

    # HTTP beside stdin, watching a training run's checkpoint:
    python -m gan_image_captioning_tpu_torch.serve --checkpoint \
        save/debug_1/models/adv_model.ckpt --dataset synthetic \
        --http-port 8080 --serve-watch 30 --serve-continuous
    curl -d '{"n": 2}' http://127.0.0.1:8080/
"""

from __future__ import annotations

import json
import os
import queue
import socketserver
import sys
import threading
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
from gan_image_captioning_tpu_torch.eval.speculative import (
    speculative_greedy)
from gan_image_captioning_tpu_torch.serving import (CoalescingBatcher,
                                                    ContinuousBatcher,
                                                    EngineOverloaded)
from gan_image_captioning_tpu_torch.train import checkpoint as ckpt_lib


# the flags of src/serve.py the port does not honour yet, as the training
# flags' table in config.py: (flag, argparse keywords with the JAX name,
# type and default, the values the port honours or None for the default)
_UNPORTED_SERVE_ARGS = (
    ("--exported", dict(type=str, default=""), None),
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


def add_decode_mode_args(parser):
    """``--decode-mode`` and ``--draft-len`` (``src/serve.py`` and
    ``src/caption.py`` name them alike)."""
    parser.add_argument("--decode-mode", type=str, default="auto",
                        choices=["auto", "greedy", "beam", "sample",
                                 "speculative"],
                        help="'auto' = beam when --beam-size > 1 else "
                             "greedy; 'sample' draws from the temperature/"
                             "top-k/top-p filtered distribution; "
                             "'speculative' gives the greedy captions "
                             "through the quantized draft and a verify "
                             "pass (LSTM only)")
    parser.add_argument("--draft-len", type=int, default=4,
                        help="speculative mode: tokens the draft proposes "
                             "a block (K)")


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
    parser.add_argument("--http-port", type=int, default=0,
                        help="HTTP port on 127.0.0.1: POST / with a request "
                             "body, GET /stats, /healthz and /metrics (0 = "
                             "off); composes with --port")
    parser.add_argument("--serve-watch", type=float, default=0.0,
                        help="poll the serving checkpoint every N seconds "
                             "and reload it once a change has held still "
                             "for two polls (0 = off)")
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
    add_decode_mode_args(parser)
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
        self.args = args
        self.mode = decode_mode(args, self.config)
        if self.mode == "speculative" and self.config.gen_arch != "lstm":
            raise SystemExit("--decode-mode speculative requires the LSTM "
                             "generator")
        # a conditional transformer's rows: features, then the grid [P, C]
        self.context_shape = (
            grid_shape(self.config) if self.config.cgan
            and self.config.gen_arch == "transformer" else None)
        self.row_dim = self.config.gen_embed_dim + (
            0 if self.context_shape is None else int(np.prod(
                self.context_shape)))
        if args.checkpoint:
            generator = self._load(args.checkpoint)
            self.checkpoint_path = args.checkpoint
        else:
            rng = torch.Generator().manual_seed(args.init_seed)
            generator = init_generator(rng, self.config, self.device,
                                       sweep=args.init_sweep)
            self.checkpoint_path = f"init-seed:{args.init_seed}"
        # (generator, decode params), swapped together by a reload: the
        # decode reads the quantized twin under --quantize (and the draft
        # under speculative mode); the start token's feature row and the
        # encoder stay full precision
        self._models = self._prepare(generator)
        self.adaptive_chunk = int(args.serve_adaptive_chunk)
        self.sample_calls = 0        # read and advanced by the dispatcher
        self._want_continuous = (args.serve_continuous
                                 and self.config.beam_size == 1
                                 and self.mode != "sample")
        self._reload_lock = threading.Lock()
        self._watch_stop = self._watch_thread = None
        self.continuous = None
        self.batcher = CoalescingBatcher(
            self._run_decode, self.batch_size, self.row_dim,
            bucket_sizes=_parse_buckets(args.serve_buckets, self.batch_size),
            max_pending=args.serve_max_pending)
        try:
            self.continuous = self._build_continuous(*self._models)
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

    @property
    def generator(self):
        return self._models[0]

    @property
    def dec_params(self):
        return self._models[1]

    def _load(self, path: str):
        return ckpt_lib.load_generator_checkpoint(path, self.config,
                                                  self.device)[0]

    def _prepare(self, generator):
        """A loaded generator → ``(generator, decode params)``: its
        quantized twin under ``--quantize``, and always in speculative mode
        (the draft; the generator is the verify target)."""
        generator = generator.requires_grad_(False)
        if self.config.quantize != "none" or self.mode == "speculative":
            return generator, quantize_generator(generator, self.config)
        return generator, generator

    def _build_continuous(self, generator, dec_params):
        """A slot-pool engine over these weights, or None when the service
        runs the coalescing engine alone."""
        if not self._want_continuous:
            return None
        a = self.args
        if self.mode == "speculative":
            return ContinuousBatcher(
                generator, self.config, num_slots=self.batch_size,
                chunk_steps=a.draft_len, early_exit=not a.serve_exact,
                max_pending=a.serve_max_pending, draft_params=dec_params)
        return ContinuousBatcher(
            dec_params, self.config, num_slots=self.batch_size,
            chunk_steps=a.serve_chunk_steps, early_exit=not a.serve_exact,
            max_pending=a.serve_max_pending,
            context_shape=self.context_shape)

    def _warm(self, n: int) -> None:
        """A request of n rows: ``{"n": n}``, or n blank images for a
        conditional transformer (its rows carry a grid)."""
        if self.context_shape is None:
            self.handle_request({"n": n})
        else:
            s = self.config.image_size
            self.caption_images(np.zeros((n, 3, s, s), np.float32))

    def _warm_row(self, generator) -> np.ndarray:
        """One engine row of ``generator``: its start-token features, or a
        blank image's row for a conditional model."""
        if not self.config.cgan:
            return start_token_features(self.config, generator,
                                        1).cpu().numpy()[0]
        s = self.config.image_size
        return self.features_from_images(np.zeros((1, 3, s, s), np.float32),
                                         generator)[0]

    def _run_decode(self, feats: np.ndarray):
        """One dispatched batch → ``(ids, seq_logprob)`` on the device.
        A conditional transformer's rows are split into the features and
        the grid, its ``context``."""
        generator, dec = self._models      # one pair for the whole batch
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
                dec, x, self.config, rng,
                temperature=a.sample_temperature, top_k=a.top_k,
                top_p=a.top_p, early_stop=not a.serve_exact,
                repetition_penalty=a.repetition_penalty,
                no_repeat_ngram=a.no_repeat_ngram, min_length=a.min_length,
                context=ctx)
        if self.mode == "speculative":
            # greedy ids from the draft / verify blocks, ending once every
            # row has committed <E> (the rescore's mask drops the <PAD>
            # tail), and the logprobs of one rescoring pass
            ids = speculative_greedy(generator, dec, x, self.config,
                                     draft_len=a.draft_len,
                                     early_stop=not a.serve_exact)
            return ids, decode_lib.sequence_logprob(generator, x, ids,
                                                    self.config)
        if self.config.beam_size > 1:
            return decode_lib.beam_search(
                dec, x, self.config, beam_size=self.config.beam_size,
                length_penalty=self.config.length_penalty,
                min_length=a.min_length, context=ctx)
        if self.adaptive_chunk > 0:
            return decode_lib.greedy_with_logprobs_adaptive(
                dec, x, self.config, context=ctx, chunk=self.adaptive_chunk)
        return decode_lib.greedy_with_logprobs(dec, x, self.config,
                                               context=ctx)

    # ----------------------------------------------------------- reload

    def reload_checkpoint(self, path: str) -> dict:
        """Swap to the checkpoint at ``path`` without downtime.

        The coalescing engine reads the models per batch, so it swaps with
        the ``(generator, decode params)`` pair.  A continuous engine
        carries its slots' state over its weights, so a successor is built
        over the new weights (its own tensors: nothing shared with the
        engine still serving) and warmed with one request while the old one
        serves; then models, engine and checkpoint path swap together, and
        the old engine finishes its slots and closes.  A failure to load,
        build or warm closes the successor and raises with the service
        untouched."""
        with self._reload_lock:
            generator, dec = self._prepare(self._load(path))
            old, new = self.continuous, None
            if old is not None:
                new = self._build_continuous(generator, dec)
                try:
                    new.submit(self._warm_row(generator)).result(timeout=120)
                except BaseException:
                    new.close()
                    raise
            self._models = (generator, dec)
            if new is not None:
                self.continuous = new
            self.checkpoint_path = path
            if self._watch_stop is not None:
                # a reload by request is no change for the watcher to redo
                self._watch_fp = checkpoint_fingerprint(path)
                self._watch_pending = None
            if old is not None:
                _drain_and_close(old)
        return {"reloaded": path}

    def start_watch(self, interval_s: float) -> None:
        """``--serve-watch``: a daemon thread polls the serving checkpoint's
        fingerprint every ``interval_s`` seconds and reloads it once a
        change has held still across two polls (a checkpoint being written
        is not read half-way; a reload that fails anyway is reported and
        retried at the next poll)."""
        self._watch_fp = checkpoint_fingerprint(self.checkpoint_path)
        self._watch_pending = None
        stop = self._watch_stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                try:
                    fp = checkpoint_fingerprint(self.checkpoint_path)
                    if fp is None or fp == self._watch_fp:
                        self._watch_pending = None
                        continue
                    if fp != self._watch_pending:
                        self._watch_pending = fp   # changed: await stability
                        continue
                    self.reload_checkpoint(self.checkpoint_path)
                    self._watch_fp, self._watch_pending = fp, None
                    print(json.dumps({"reloaded": self.checkpoint_path,
                                      "watch": True}), flush=True)
                except Exception as exc:  # a torn write: the next poll retries
                    print(json.dumps({"watch_error": f"{type(exc).__name__}: "
                                                     f"{exc}"}), flush=True)

        self._watch_thread = threading.Thread(target=loop, daemon=True,
                                              name="checkpoint-watch")
        self._watch_thread.start()

    def stop_watch(self) -> None:
        """End the ``--serve-watch`` thread and wait for it."""
        if self._watch_stop is not None:
            self._watch_stop.set()
            self._watch_thread.join(timeout=150)
            self._watch_stop = self._watch_thread = None

    # --------------------------------------------------------- requests

    def _features_unconditional(self, n: int) -> np.ndarray:
        return start_token_features(self.config, self.generator,
                                    n).cpu().numpy()

    @torch.no_grad()
    def features_from_images(self, images: np.ndarray,
                             generator=None) -> np.ndarray:
        """The device part of an image request: normalized ``[N, 3, S, S]``
        float32 images → ``[N, E]`` features from one eval-mode encoder
        pass (``generator_condition(train=False)``) of ``generator`` (the
        serving one by default); a conditional transformer's rows are
        ``[N, E + P·C]``, the features and the flattened grid."""
        batch = {"images": torch.from_numpy(
            np.ascontiguousarray(images, np.float32)).to(self.device)}
        cond, _ = generator_condition(self.config,
                                      generator or self.generator, batch,
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

        ``emit`` (optional): a callable the transports pass so that
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
        if "reload" in req:
            out = self.reload_checkpoint(str(req["reload"]))
            out["latency_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
            return out
        if "image" in req:
            if not self.config.cgan:
                return {"error": "checkpoint is unconditional; use {'n': k}"}
            paths = req["image"]
            if isinstance(paths, str):
                paths = [paths]
            if not paths:
                return {"error": "'image' must be a path or non-empty list"}
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
                             "streaming transport: stdin, --port TCP or "
                             "HTTP)"}
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
        every row has resolved.  A reload can close the engine between
        reading it and submitting: the one retry lands on its successor."""
        events = queue.Queue() if emit is not None else None
        on_tokens = (None if events is None else
                     (lambda j, ids, done: events.put((j, ids, done))))
        for attempt in (0, 1):
            try:
                futs = self.continuous.submit_many(list(feats),
                                                   on_tokens=on_tokens)
                break
            except RuntimeError as exc:
                if "closed" not in str(exc) or attempt:
                    raise
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
        self.stop_watch()
        if self.continuous is not None:
            self.continuous.close()
        self.batcher.close()


def checkpoint_fingerprint(path: str):
    """What ``--serve-watch`` compares: ``(name, size, mtime_ns)`` of the
    checkpoint file (of every file under it, for a directory); None when
    it is missing.  Any rewrite changes it."""
    if not os.path.exists(path):
        return None
    if os.path.isfile(path):
        st = os.stat(path)
        return ((path, st.st_size, st.st_mtime_ns),)
    out = []
    for root, _, names in os.walk(path):
        for name in names:
            p = os.path.join(root, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            out.append((os.path.relpath(p, path), st.st_size,
                        st.st_mtime_ns))
    return tuple(sorted(out))


def _drain_and_close(engine, timeout_s: float = 60.0):
    """Let a superseded slot engine finish its slots (new requests already
    go to its successor), then close it."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        s = engine.stats()
        if s["active_slots"] == 0 and s["queue_depth"] == 0:
            break
        time.sleep(0.02)
    engine.close()


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


def prometheus_text(stats: dict) -> str:
    """``{"stats": true}``'s engine counters as Prometheus text:
    ``gic_serving_<counter>{engine="<engine>"} <value>``."""
    lines = [f'gic_serving_{k}{{engine="{engine}"}} {v}'
             for engine, vals in stats.items() if isinstance(vals, dict)
             for k, v in vals.items()
             if isinstance(v, (int, float)) and not isinstance(v, bool)]
    return "\n".join(lines) + "\n"


def make_http_server(service: CaptionService, port: int):
    """HTTP front end on 127.0.0.1 over the same engines (a
    ``ThreadingHTTPServer``: concurrent requests coalesce like TCP ones).

    * ``POST /`` with a request body → its response: 200, 400 for a body
      that is not JSON or a response that is an error, 503 when the engine
      is at ``--serve-max-pending`` (shed load), 500 for any other fault;
      ``{"stream": true}`` answers chunked NDJSON: a line per decode chunk,
      then the response (an error after the first line ends the stream
      with an ``{"error"}`` line).
    * ``GET /stats`` (JSON), ``/healthz``, ``/metrics`` (Prometheus text);
      404 for any other path."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    def fault_code(exc):
        return 503 if isinstance(exc, EngineOverloaded) else 500

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, obj, content_type="application/json"):
            body = (obj if isinstance(obj, bytes)
                    else (json.dumps(obj) + "\n").encode())
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            try:
                if self.path == "/healthz":
                    self._send(200, {"status": "ok"})
                elif self.path == "/stats":
                    self._send(200, service.handle_request({"stats": True}))
                elif self.path == "/metrics":
                    self._send(200, prometheus_text(service.handle_request(
                        {"stats": True})).encode(),
                        content_type="text/plain; version=0.0.4")
                else:
                    self._send(404, {"error": "GET /stats | /healthz | "
                                              "/metrics, POST /"})
            except Exception as exc:  # never drop the connection replyless
                self._send(500, {"error": f"{type(exc).__name__}: {exc}"})

        def do_POST(self):
            if self.path != "/":
                self._send(404, {"error": "POST /"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("the body must be a JSON object")
            except Exception as exc:
                self._send(400, {"error": f"malformed request: {exc}"})
                return
            if req.get("stream"):
                self._stream(req)
                return
            try:
                resp = service.handle_request(req)
            except Exception as exc:
                self._send(fault_code(exc),
                           {"error": f"{type(exc).__name__}: {exc}"})
                return
            self._send(400 if "error" in resp else 200, resp)

        def _stream(self, req):
            started = []

            def emit(obj):
                if not started:
                    started.append(True)
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                data = (json.dumps(obj) + "\n").encode()
                self.wfile.write(f"{len(data):x}\r\n".encode() + data
                                 + b"\r\n")
                self.wfile.flush()

            try:
                resp = service.handle_request(req, emit=emit)
            except Exception as exc:
                resp = {"error": f"{type(exc).__name__}: {exc}"}
                if not started:
                    self._send(fault_code(exc), resp)
                    return
            if "error" in resp and not started:
                self._send(400, resp)
                return
            emit(resp)
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

        def log_message(self, *a):  # quiet: the counters are in /metrics
            pass

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def serve_stdin(service: CaptionService, lines) -> None:
    """The JSON-lines loop over ``lines`` (stdin), answers on stdout."""
    def emit(obj):
        print(json.dumps(obj), flush=True)

    for line in lines:
        if line.strip():
            emit(service.handle_line(line, emit=emit))


def main(argv=None):
    args = parse_args(argv)
    service = CaptionService(args)
    try:
        if args.serve_watch > 0:
            service.start_watch(args.serve_watch)
        print(json.dumps({"status": "ready",
                          "vocab_size": service.config.vocab_size,
                          "device": str(service.device)}), flush=True)
        servers = []
        if args.http_port:
            servers.append(make_http_server(service, args.http_port))
        if args.port:
            servers.append(make_tcp_server(service, args.port))
        if not servers:
            serve_stdin(service, sys.stdin)
            return
        # --port and --http-port compose: the first runs in a daemon
        # thread, the last in the foreground, both over the same service
        for srv in servers[:-1]:
            threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            servers[-1].serve_forever()
        finally:
            for srv in servers:
                if srv is not servers[-1]:
                    srv.shutdown()
                srv.server_close()
    finally:
        service.close()


if __name__ == "__main__":
    main()
