"""The port's training entry point (``python -m
gan_image_captioning_tpu_torch.main``) on the CPU against the JAX
package's ``GANInstructor`` on the same conditional synthetic data: the
JAX instructor's initial generator is carried in through
``--init-gen-ckpt`` (exported in the reference layout), both run two
teacher-forced pretrain epochs and one adversarial epoch with
``disc_train_freq`` 2, and the per-epoch train and val losses must agree
within 1e-4 relative (the same batches in the same seeded order; float32
sums in another order through Adam).  The adversarial epoch's step
counters and temperatures must equal the JAX run's; the checkpoints must
exist and serve ``{"image": …}``.  Then the flags the port does not
honour yet must raise, and a missing CUDA device too.  The JAX side runs
with ``--num-workers 0 --device-prefetch 0``: no background threads."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.synthetic import (
    SyntheticCaptions as JSynthetic)
from gan_image_captioning_tpu.models.torch_export import generator_to_torch
from gan_image_captioning_tpu.train.instructor import GANInstructor
from gan_image_captioning_tpu_torch import main as tmain
from gan_image_captioning_tpu_torch import serve
from gan_image_captioning_tpu_torch.config import (build_parser,
                                                   config_from_args,
                                                   require_ported_flags)

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

ITEMS, S, BS = 32, 32, 8
MODEL = dict(gen_embed_dim=16, gen_hidden_dim=16, gen_num_layers=2,
             max_seq_len=8, disc_embed_dim=8, disc_num_rep=4,
             disc_filter_sizes=(2, 3), disc_num_filters=(6, 6),
             disc_train_freq=2, mle_objective="teacher", image_size=S,
             conditional_gan=1, pre_train_batch_size=BS,
             pre_eval_batch_size=BS, adv_train_batch_size=BS,
             adv_eval_batch_size=BS, pretrain_epochs=2, adv_epochs=1)
FLAGS = ["--dataset", "synthetic", "--synthetic-items", str(ITEMS),
         "--conditional-gan", "1", "--image-size", str(S),
         "--gen-embed-dim", "16", "--gen-hidden-dim", "16",
         "--gen-num-layers", "2", "--max-seq-len", "8",
         "--disc-embed-dim", "8", "--disc-num-rep", "4",
         "--disc-filter-sizes", "2,3", "--disc-num-filters", "6,6",
         "--disc-train-freq", "2", "--mle-objective", "teacher",
         "--pre-train-batch-size", str(BS), "--pre-eval-batch-size", str(BS),
         "--adv-train-batch-size", str(BS), "--adv-eval-batch-size", str(BS),
         "--pretrain-epochs", "2", "--adv-epochs", "1"]


def _metrics(save_dir):
    rows = [json.loads(ln) for ln in open(os.path.join(save_dir,
                                                       "metrics.jsonl"))]
    out = {}
    for r in rows:
        out.setdefault(r["tag"], []).append((r["step"], r["value"]))
    return out


def _epoch_means(rows, per_epoch):
    vals = [v for _, v in rows]
    return [float(np.mean(vals[i:i + per_epoch]))
            for i in range(0, len(vals), per_epoch)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop")
    jdir = str(tmp / "jax")
    train = JSynthetic("train", num_items=ITEMS, image_size=S,
                       conditional=True, seed=1008)
    val = JSynthetic("val", num_items=max(ITEMS // 4, 16), image_size=S,
                     conditional=True, seed=1008)
    jconfig = JConfig(vocab_size=train.vocab_size, num_workers=0,
                      device_prefetch=0, save_dir=jdir,
                      model_dir=os.path.join(jdir, "models"),
                      log_file=os.path.join(jdir, "log"), **MODEL)
    jinst = GANInstructor(jconfig, train, val, silent=True)
    init = str(tmp / "jax_init_generator.ckpt")
    torch.save(generator_to_torch(jax.tree_util.tree_map(
        np.asarray, jinst.state.gen_params)), init)
    jinst._run()

    inst = tmain.main([*FLAGS, "--init-gen-ckpt", init, "--device", "cpu",
                       "--save-dir", str(tmp / "port"), "--expt-name", "run",
                       "--num-workers", "0", "--device-prefetch", "0"])
    return jinst, inst


def test_pretrain_epoch_losses_match_jax(runs):
    jinst, inst = runs
    jm, tm = _metrics(jinst.config.save_dir), _metrics(inst.config.save_dir)
    n_train, n_val = ITEMS // BS, 2
    for tag, per in (("GenPreTraining_train_loss", n_train),
                     ("GenPreTraining_val_loss", n_val)):
        want, got = _epoch_means(jm[tag], per), _epoch_means(tm[tag], per)
        assert len(got) == len(want) == 2, tag
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=tag)
        # the steps each value is logged at
        assert [s for s, _ in tm[tag]] == [s for s, _ in jm[tag]], tag
    assert inst.pretrain_steps == jinst.pretrain_steps == 2 * n_train


def test_adversarial_epoch_counters_and_temperature_match_jax(runs):
    jinst, inst = runs
    assert inst.state.gen_steps == int(jinst.state.gen_steps) == ITEMS // BS
    assert inst.state.disc_steps == int(jinst.state.disc_steps) == 2
    assert inst.adv_batch_steps == jinst.adv_batch_steps
    np.testing.assert_allclose(inst.state.temperature,
                               float(jinst.state.temperature), rtol=1e-6)
    for frac in (0.25, 0.5, 1.0):
        assert inst._temperature(0, frac) == pytest.approx(
            jinst._temperature(0, frac), rel=1e-12)
    jm, tm = _metrics(jinst.config.save_dir), _metrics(inst.config.save_dir)
    assert set(tm) <= set(jm)
    assert set(jm) - set(tm) == set()
    for tag in ("Generator_train_loss", "Discriminator_val_loss"):
        assert [s for s, _ in tm[tag]] == [s for s, _ in jm[tag]], tag
    assert all(np.isfinite(v) for rows in tm.values() for _, v in rows)


def test_run_dir_and_checkpoints_serve_images(runs):
    _, inst = runs
    save = inst.config.save_dir
    assert os.path.basename(save) == "run_1"
    with open(os.path.join(save, "config.json")) as f:
        dumped = json.load(f)
    assert dumped["vocab_size"] == inst.config.vocab_size
    assert dumped["conditional_gan"] == 1
    assert os.path.exists(os.path.join(save, "log.txt"))
    images = np.stack([JSynthetic("test", image_size=S, conditional=True)
                       .sample(i)[1] for i in range(3)])
    for name in ("pretrained_model.ckpt", "adv_model.ckpt"):
        path = os.path.join(inst.config.model_dir, name)
        assert os.path.isfile(path)
        service = serve.CaptionService(serve.parse_args(
            ["--checkpoint", path, *FLAGS, "--device", "cpu"]))
        try:
            resp = service.caption_images(images)
            assert len(resp["captions"]) == 3
            assert all(np.isfinite(resp["logprobs"]))
        finally:
            service.close()
    adv = torch.load(os.path.join(inst.config.model_dir, "adv_model.ckpt"),
                     weights_only=True)
    assert adv["conditional"] is True and "convs.0.weight" in adv[
        "discriminator"]


def test_main_needs_cuda_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = build_parser().parse_args([])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.main([*FLAGS, "--save-dir", str(tmp_path / "s")])
    assert not os.path.exists(tmp_path / "s")   # refused before any dir
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.CaptionService(serve.parse_args(["--init-seed", "0",
                                               "--dataset", "synthetic"]))


UNPORTED = [("--random-flip", "1"), ("--random-crop-pad", "4"),
            ("--cache-features", "1"), ("--mesh", "data:4")]


@pytest.mark.parametrize("flag,value", UNPORTED)
def test_unported_flags_raise(flag, value, tmp_path):
    args = build_parser().parse_args([flag, value])
    with pytest.raises(NotImplementedError):
        require_ported_flags(config_from_args(args))
    with pytest.raises(NotImplementedError):
        tmain.main([*FLAGS, flag, value, "--device", "cpu",
                    "--save-dir", str(tmp_path / "s")])
    assert not os.path.exists(tmp_path / "s")


def test_vit_encoder_trains(tmp_path, monkeypatch):
    """``--encoder-arch vit``, refused until its port: the conditional LSTM
    trains on the ViT-B/16 backbone's CLS features (frozen: its weights do
    not move) and the checkpoint serves an image.  Two of the ViT's twelve
    blocks, at its width (``test_torch_port_vit.py`` holds all twelve)."""
    from gan_image_captioning_tpu_torch.models import vit as tvit

    monkeypatch.setattr(tvit, "DEPTH", 2)
    inst = tmain.main([*FLAGS, "--encoder-arch", "vit", "--image-size", "32",
                       "--device", "cpu", "--save-dir", str(tmp_path / "s")])
    gen = inst.state.gen
    assert gen.encoder.backbone is gen.encoder.vit
    assert not any(k.startswith("encoder.vit.")
                   for k in inst.state.gen_opt.mu)
    service = serve.CaptionService(serve.parse_args(
        ["--checkpoint", os.path.join(inst.config.model_dir,
                                      "adv_model.ckpt"),
         *FLAGS, "--encoder-arch", "vit", "--image-size", "32",
         "--device", "cpu"]))
    try:
        resp = service.caption_images(np.zeros((2, 3, 32, 32), np.float32))
        assert len(resp["captions"]) == 2
    finally:
        service.close()


@pytest.mark.parametrize("flag,value", [("--eval-bleu-every", "1"),
                                        ("--beam-size", "4")])
def test_quality_eval_flags_are_honoured(flag, value, tmp_path):
    """The quality eval's flags run: each adversarial epoch ends with the
    ``[EVAL]`` line (greedy, or beam search at ``--beam-size 4``)."""
    argv = [flag, value] + (["--eval-bleu-every", "1"]
                            if flag == "--beam-size" else [])
    inst = tmain.main([*FLAGS, *argv, "--pretrain-epochs", "0",
                       "--device", "cpu", "--save-dir", str(tmp_path / "s")])
    assert getattr(inst.config, flag[2:].replace("-", "_")) == int(value)
    log = open(inst.config.log_file + ".txt").read()
    assert log.count("[EVAL] NLL_gen") == 1


def test_loader_flags_are_accepted():
    args = build_parser().parse_args(["--num-workers", "8",
                                      "--device-prefetch", "4"])
    require_ported_flags(config_from_args(args))


@pytest.mark.parametrize("preset,want", [
    ("config1", dict(conditional_gan=1, mle_objective="teacher",
                     pretrain_epochs=20, adv_epochs=0,
                     pre_train_batch_size=32)),
    ("config3", dict(conditional_gan=0, gen_embed_dim=512, gen_num_layers=2,
                     pretrain_lr=1e-2, gen_lr=1e-4, dataset_percent=0.1))])
def test_presets_are_the_jax_flag_bundles(preset, want):
    from gan_image_captioning_tpu.config import get_args

    args = build_parser().parse_args(["--preset", preset])
    jargs = get_args(["--preset", preset], make_dirs=False)
    for k, v in want.items():
        assert getattr(args, k) == getattr(jargs, k) == v, k
    # explicit flags still win
    args = build_parser().parse_args(["--preset", preset,
                                      "--gen-embed-dim", "64"])
    assert args.gen_embed_dim == 64


def test_config2_needs_greedy_decoding():
    """Preset config2 runs at its own beam 4 (it needed ``--beam-size 1``
    until beam search was ported); ``--beam-size 1`` still picks greedy."""
    args = build_parser().parse_args(["--preset", "config2"])
    assert (args.conditional_gan, args.gen_embed_dim, args.beam_size) == (
        1, 512, 4)
    config = config_from_args(args)
    require_ported_flags(config)
    assert config.beam_size == 4
    args = build_parser().parse_args(["--preset", "config2",
                                      "--beam-size", "1"])
    require_ported_flags(config_from_args(args))


@pytest.mark.parametrize("preset", ["config4", "config5"])
def test_conditional_transformer_presets_parse(preset):
    """Refused until the conditional transformer's port: config4 with
    ``--conditional-gan 1``, and config5 (ViT encoder, GPT-2 geometry,
    BPE, bfloat16, device preprocessing) as it is parsed."""
    extra = ["--conditional-gan", "1"] if preset == "config4" else []
    config = config_from_args(build_parser().parse_args(
        ["--preset", preset, *extra]))
    require_ported_flags(config)
    assert config.cgan and config.gen_arch == "transformer"
    if preset == "config5":
        assert (config.encoder_arch, config.gen_embed_dim, config.tokenizer,
                config.dtype, config.device_preprocess) == (
                    "vit", 768, "bpe", "bfloat16", 1)
