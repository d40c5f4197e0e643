"""The port's evaluation surfaces against the JAX package's on the CPU, on
the same weights and the same conditional synthetic split (32 x 32
images, the ResNet-18 encoder):

* ``python -m gan_image_captioning_tpu_torch.evaluate`` against
  ``src/evaluate.py``: the same JSON keys; BLEU, CIDEr-D, ROUGE-L, METEOR,
  self-BLEU, distinct-n and the oracle BLEU equal (the decoded ids are);
  NLL_gen and the discriminator scores within one unit of the 4th
  decimal, to which both round them; greedy, beam (with the length
  penalty, multi-reference), diverse beam, the adaptive decode and int8;
* ``caption.py`` against ``src/caption.py``: the same lines (captions and
  references equal, log-probabilities within 1e-5);
* the instructor's ``evaluate_quality`` against the JAX one (NLL_gen
  within 1e-5, BLEU-4 and self-BLEU equal), and ``--eval-bleu-every`` in
  the port's loop;
* ``serve.py --decode-mode beam|sample`` answering requests.

The JAX checkpoint is written by the JAX package (orbax), the port's in
the reference layout from the same trees; the generator's weights are
scaled by ``PEAK`` (``test_torch_port_beam.py``) so that beams and greedy
steps are not decided by float32 rounding."""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

import src.caption as jcaption
import src.evaluate as jevaluate
from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.synthetic import (
    SyntheticCaptions as JSynthetic)
from gan_image_captioning_tpu.models import api as japi
from gan_image_captioning_tpu.models.torch_export import (
    discriminator_to_torch, generator_to_torch)
from gan_image_captioning_tpu.data.coco import CocoCaptions as JCoco
from gan_image_captioning_tpu.train import checkpoint as jckpt
from gan_image_captioning_tpu.train import steps as jsteps
from gan_image_captioning_tpu.train.instructor import (
    GANInstructor as JInstructor)
from gan_image_captioning_tpu_torch import caption as tcaption
from gan_image_captioning_tpu_torch import evaluate as tevaluate
from gan_image_captioning_tpu_torch import main as tmain
from gan_image_captioning_tpu_torch import serve
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.coco import CocoCaptions
from gan_image_captioning_tpu_torch.data.synthetic import SyntheticCaptions
from gan_image_captioning_tpu_torch.eval import decode as tdecode
from gan_image_captioning_tpu_torch.interop import generator_from_jax
from gan_image_captioning_tpu_torch.models.api import start_token_features
from gan_image_captioning_tpu_torch.train.instructor import GANInstructor
from gan_image_captioning_tpu_torch.train.state import with_generator
from test_torch_port_beam import peaked

ITEMS, BS, S = 32, 8, 32
V = JSynthetic("train", num_items=4).vocab_size
MODEL = dict(vocab_size=V, gen_embed_dim=16, gen_hidden_dim=16,
             gen_num_layers=2, max_seq_len=8, disc_embed_dim=8,
             disc_num_rep=4, disc_filter_sizes=(2, 3),
             disc_num_filters=(6, 6), conditional_gan=1, image_size=S)
FLAGS = ["--dataset", "synthetic", "--synthetic-items", str(ITEMS),
         "--conditional-gan", "1", "--image-size", str(S),
         "--gen-embed-dim", "16", "--gen-hidden-dim", "16",
         "--gen-num-layers", "2", "--max-seq-len", "8",
         "--disc-embed-dim", "8", "--disc-num-rep", "4",
         "--disc-filter-sizes", "2,3", "--disc-num-filters", "6,6",
         "--pre-eval-batch-size", str(BS), "--num-workers", "0",
         "--device", "cpu"]
ROUNDED = ("nll_gen", "disc_score_generated", "disc_score_real")


@pytest.fixture(autouse=True)
def no_state_shardings():
    """The JAX steps without process-wide state shardings: the ZeRO-1
    instructor test (``tests/test_parallel.py``) leaves them set on its
    worker, and the JAX side here runs without a mesh."""
    prev = jsteps._STATE_SHARDINGS
    jsteps.set_state_shardings(None)
    yield
    jsteps.set_state_shardings(prev)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """``(JAX checkpoint, port checkpoint, JAX generator params)``."""
    tmp = tmp_path_factory.mktemp("eval")
    jconfig = JConfig(**MODEL)
    gp = japi.init_generator(jax.random.PRNGKey(0), jconfig)
    gp = dict(gp, decoder=peaked(gp["decoder"]))
    dp = japi.init_discriminator(jax.random.PRNGKey(1), jconfig)
    jpath, tpath = str(tmp / "jax_adv.ckpt"), str(tmp / "port_adv.ckpt")
    jckpt.save_params(jpath, {"generator": gp, "discriminator": dp},
                      sync=True)
    np_tree = jax.tree_util.tree_map(np.asarray, (gp, dp))
    torch.save({"generator": generator_to_torch(np_tree[0]),
                "discriminator": discriminator_to_torch(np_tree[1]),
                "conditional": True}, tpath)
    return jpath, tpath, gp


def _stdout_json(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


# case → (flags, the port's decode function the case must call)
EVAL_CASES = {
    "greedy": (["--diversity", "--cider", "--rouge", "--meteor",
                "--disc-score"], "greedy"),
    "beam": (["--beam-size", "4", "--length-penalty", "0.6", "--diversity",
              "--cider", "--rouge", "--meteor", "--multi-ref"],
             "beam_search"),
    "diverse": (["--beam-size", "4", "--beam-groups", "2", "--diversity",
                 "--disc-score"], "diverse_beam_search"),
    "adaptive": (["--adaptive-chunk", "3", "--cider", "--split", "train",
                  "--max-batches", "2"], "greedy_with_logprobs_adaptive"),
    "int8": (["--quantize", "int8", "--rouge", "--meteor"], "greedy"),
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_evaluate_matches_jax(checkpoints, case, monkeypatch):
    """At initialization the encoder gives every image nearly the same
    features, so the rows decode alike: which decode ran is checked by
    the call it makes."""
    jpath, tpath, _ = checkpoints
    extra, decode_fn = EVAL_CASES[case]
    want = _stdout_json(jevaluate.main, [*FLAGS, "--checkpoint", jpath,
                                         *extra])
    calls, real = [], getattr(tdecode, decode_fn)

    def spy(gen, *args, **kwargs):
        calls.append(isinstance(gen, dict))        # the quantized twin
        return real(gen, *args, **kwargs)

    monkeypatch.setattr(tdecode, decode_fn, spy)
    got = _stdout_json(tevaluate.main, [*FLAGS, "--checkpoint", tpath,
                                        *extra])
    assert calls and all(q == (case == "int8") for q in calls)
    assert set(got) == set(want)
    for key, value in want.items():
        if key in ROUNDED:
            assert abs(got[key] - value) <= 1.0001e-4, (key, got, want)
        else:
            assert got[key] == value, (key, got, want)
    assert 0.0 <= got["bleu4"] <= 1.0 and np.isfinite(got["nll_gen"])
    if "--diversity" in extra:
        assert got["distinct1"] > 0.0


def test_evaluate_entry_point_refusals(checkpoints):
    _, tpath, _ = checkpoints
    with pytest.raises(NotImplementedError, match="--mesh"):
        tevaluate.main([*FLAGS, "--checkpoint", tpath, "--mesh", "data:2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tevaluate.main([*FLAGS[:-2], "--checkpoint", tpath])


def _lines(path):
    return [json.loads(ln) for ln in open(path)]


CAPTION_CASES = {
    "greedy": [],
    "beam": ["--beam-size", "4", "--min-length", "3"],
    "diverse": ["--decode-mode", "beam", "--beam-size", "4",
                "--beam-groups", "2"],
    "sample_top1": ["--decode-mode", "sample", "--top-k", "1"],
}


@pytest.mark.parametrize("case", sorted(CAPTION_CASES))
def test_caption_matches_jax(checkpoints, tmp_path, case):
    jpath, tpath, _ = checkpoints
    extra = [*CAPTION_CASES[case], "--num-samples", "10"]
    jout, tout = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jcaption.main([*FLAGS, "--checkpoint", jpath, "--output", jout, *extra])
    tcaption.main([*FLAGS, "--checkpoint", tpath, "--output", tout, *extra])
    want, got = _lines(jout), _lines(tout)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("caption", "captions", "reference"):
            assert g.get(key) == w.get(key)
        np.testing.assert_allclose(g.get("logprob", g.get("logprobs")),
                                   w.get("logprob", w.get("logprobs")),
                                   atol=1e-5)


def test_caption_sampling_is_seeded(checkpoints, tmp_path):
    _, tpath, _ = checkpoints
    runs = []
    for seed in (0, 0, 1):
        out = str(tmp_path / f"s{len(runs)}.jsonl")
        tcaption.main([*FLAGS, "--checkpoint", tpath, "--output", out,
                       "--decode-mode", "sample", "--top-p", "0.9",
                       "--no-repeat-ngram", "2", "--sample-seed", str(seed),
                       "--num-samples", "12"])
        runs.append([ln["caption"] for ln in _lines(out)])
    assert runs[0] == runs[1] and runs[0] != runs[2]
    for flag in (["--exported", "m.gic"], ["--decode-mode", "speculative"]):
        with pytest.raises(NotImplementedError):
            tcaption.main([*FLAGS, "--checkpoint", tpath, *flag])


@pytest.mark.parametrize("beam,adaptive", [(1, 0), (4, 0), (1, 3)])
def test_evaluate_quality_matches_jax(checkpoints, tmp_path, monkeypatch,
                                      beam, adaptive):
    """Greedy, beam 4, and the early-stopping greedy decode in 3-step
    chunks (the JAX package's ``GIC_EVAL_ADAPTIVE``, the port's
    ``Config.eval_adaptive_chunk``)."""
    _, _, gp = checkpoints
    monkeypatch.setenv("GIC_EVAL_ADAPTIVE", str(adaptive))
    kw = dict(MODEL, beam_size=beam, pre_eval_batch_size=BS,
              adv_eval_batch_size=BS, pre_train_batch_size=BS,
              adv_train_batch_size=BS)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jconfig = JConfig(num_workers=0, device_prefetch=0, save_dir=jdir,
                      model_dir=os.path.join(jdir, "models"),
                      log_file=os.path.join(jdir, "log"), **kw)
    jinst = JInstructor(jconfig, *(JSynthetic(
        split, num_items=n, image_size=S, conditional=True)
        for split, n in (("train", ITEMS), ("val", 16))), silent=True)
    jinst.state = jinst.state._replace(gen_params=gp)
    want = jinst.evaluate_quality()

    config = Config(device="cpu", eval_adaptive_chunk=adaptive,
                    save_dir=tdir,
                    model_dir=os.path.join(tdir, "models"),
                    log_file=os.path.join(tdir, "log"), **kw)
    inst = GANInstructor(config, *(SyntheticCaptions(
        split, num_items=n, image_size=S, conditional=True)
        for split, n in (("train", ITEMS), ("val", 16))))
    gen = generator_from_jax(jax.tree_util.tree_map(np.asarray, gp), config)
    inst.state = with_generator(inst.state, gen, config)
    got = inst.evaluate_quality()
    assert abs(got["nll_gen"] - want["nll_gen"]) <= 1e-5
    assert got["bleu4"] == want["bleu4"]
    assert got["self_bleu4"] == want["self_bleu4"]
    log = open(os.path.join(tdir, "log.txt")).read()
    assert log.count("[SAMPLE] gen: ") == 2


def test_image_key_matches_jax():
    """``--multi-ref`` groups rows by ``image_key``: one key per synthetic
    item, the file name of each COCO row."""
    syn, jsyn = SyntheticCaptions("val", num_items=6), JSynthetic(
        "val", num_items=6)
    assert [syn.image_key(i) for i in range(6)] == [
        jsyn.image_key(i) for i in range(6)]
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "mini_coco")
    path = os.path.join(root, "dataset_coco.json")
    coco = CocoCaptions(path, root, "val", 32, 5, conditional=False)
    jcoco = JCoco(path, root, "val", 32, 5, conditional=False,
                  use_native=False)
    keys = [coco.image_key(i) for i in range(len(coco))]
    assert keys == [jcoco.image_key(i) for i in range(len(jcoco))]
    assert 1 < len(set(keys)) < len(keys)      # several captions an image


def test_eval_bleu_every_in_the_loop(tmp_path):
    """``main.py --eval-bleu-every 1 --beam-size 2``: every adversarial
    epoch ends with ``[EVAL]`` and the three scalars."""
    tmain.main([*FLAGS, "--pretrain-epochs", "1", "--adv-epochs", "2",
                "--pre-train-batch-size", str(BS), "--adv-train-batch-size",
                str(BS), "--adv-eval-batch-size", str(BS),
                "--eval-bleu-every", "1", "--beam-size", "2",
                "--save-dir", str(tmp_path), "--expt-name", "q"])
    run = tmp_path / "q_1"
    tags = [json.loads(ln)["tag"] for ln in open(run / "metrics.jsonl")]
    for tag in ("NLL_gen", "BLEU4", "SelfBLEU4"):
        assert tags.count(tag) == 2
    assert open(run / "log.txt").read().count("[EVAL] NLL_gen") == 2


SERVE_FLAGS = ["--init-seed", "0", "--device", "cpu", "--dataset",
               "synthetic", "--gen-embed-dim", "16", "--gen-hidden-dim",
               "16", "--max-seq-len", "6", "--serve-batch-size", "4"]


def _service(*extra):
    return serve.CaptionService(serve.parse_args([*SERVE_FLAGS, *extra]))


def test_serve_beam_answers_as_beam_search():
    service = _service("--decode-mode", "beam", "--beam-size", "3",
                       "--length-penalty", "0.6")
    try:
        out = service.handle_request({"n": 3})
        feats = start_token_features(service.config, service.generator, 3)
        ids, scores = tdecode.beam_search(service.generator, feats,
                                          service.config, beam_size=3,
                                          length_penalty=0.6)
        assert out["captions"] == [service._caption(r) for r in ids.numpy()]
        np.testing.assert_allclose(out["logprobs"], scores.numpy(),
                                   atol=1e-4)
    finally:
        service.close()


def test_serve_sample_is_seeded_per_call():
    """Two services of one seed answer the same; a later call draws other
    noise; top-k 1 is the greedy service's answer."""
    answers = []
    for _ in range(2):
        service = _service("--decode-mode", "sample", "--top-p", "0.95",
                           "--sample-seed", "7", "--sample-temperature",
                           "2.0")
        try:
            answers.append([service.handle_request({"n": 4})["captions"]
                            for _ in range(2)])
        finally:
            service.close()
    assert answers[0] == answers[1]
    assert answers[0][0] != answers[0][1]
    greedy, top1 = _service(), _service("--decode-mode", "sample",
                                        "--top-k", "1")
    try:
        assert (top1.handle_request({"n": 2})["captions"]
                == greedy.handle_request({"n": 2})["captions"])
    finally:
        greedy.close()
        top1.close()
