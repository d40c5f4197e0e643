"""``--preset config4`` end to end on the CPU: the port's training entry
point (``python -m gan_image_captioning_tpu_torch.main``) against the JAX
package's ``GANInstructor`` on the same synthetic data, at a small width.
The JAX instructor's initial transformer generator is carried in through
``--init-gen-ckpt`` (``interop`` then the port's checkpoint); both run one
pretrain epoch (the parallel causal pass with padding masks: no noise, so
the per-epoch train and val losses must agree within 1e-4 relative) and
one REINFORCE epoch (each side draws its own noise: the step counters and
temperatures must agree, every loss must be finite).  The checkpoints must
exist, carry the transformer flag and serve ``{"n": k}``.  The preset is
the JAX flag bundle, and what config4 still lacks raises."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.config import config_from_args as jconfig_from_args
from gan_image_captioning_tpu.config import get_args
from gan_image_captioning_tpu.data.synthetic import (
    SyntheticCaptions as JSynthetic)
from gan_image_captioning_tpu.train.instructor import GANInstructor
from gan_image_captioning_tpu_torch import caption as tcaption
from gan_image_captioning_tpu_torch import interop
from gan_image_captioning_tpu_torch import main as tmain
from gan_image_captioning_tpu_torch import serve
from gan_image_captioning_tpu_torch.config import (build_parser,
                                                   config_from_args,
                                                   require_ported_flags)
from gan_image_captioning_tpu_torch.eval import decode as tdecode
from gan_image_captioning_tpu_torch.models import api as tapi
from gan_image_captioning_tpu_torch.train.checkpoint import (
    load_generator_checkpoint, save_generator_checkpoint)

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

ITEMS, BS = 16, 8
MODEL = dict(gen_embed_dim=16, gen_hidden_dim=16, gen_num_layers=1,
             gen_num_heads=2, disc_embed_dim=8, disc_hidden_dim=16,
             disc_num_heads=2, disc_num_layers=1, max_seq_len=6,
             rollout_num=2, rollout_stride=3, pre_train_batch_size=BS,
             pre_eval_batch_size=BS, adv_train_batch_size=BS,
             adv_eval_batch_size=BS, pretrain_epochs=1, adv_epochs=1)
FLAGS = ["--preset", "config4", "--dataset", "synthetic",
         "--synthetic-items", str(ITEMS)] + [
    f"--{k.replace('_', '-')}={v}" for k, v in MODEL.items()]


def _metrics(save_dir):
    out = {}
    for ln in open(os.path.join(save_dir, "metrics.jsonl")):
        r = json.loads(ln)
        out.setdefault(r["tag"], []).append((r["step"], r["value"]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tfloop")
    jdir = str(tmp / "jax")
    train = JSynthetic("train", num_items=ITEMS, seed=1008)
    val = JSynthetic("val", num_items=16, seed=1008)
    jargs = get_args(["--preset", "config4"], make_dirs=False)
    preset = {k: getattr(jargs, k) for k in (
        "gen_arch", "disc_arch", "adv_objective", "rl_baseline")}
    jconfig = JConfig(vocab_size=train.vocab_size, num_workers=0,
                      device_prefetch=0, save_dir=jdir,
                      model_dir=os.path.join(jdir, "models"),
                      log_file=os.path.join(jdir, "log"), **preset, **MODEL)
    jinst = GANInstructor(jconfig, train, val, silent=True)
    args = build_parser().parse_args(FLAGS)
    args.vocab_size = train.vocab_size
    gen = interop.transformer_generator_from_jax(
        jax.tree_util.tree_map(np.asarray, jinst.state.gen_params),
        config_from_args(args))
    init = str(tmp / "jax_init_generator.ckpt")
    save_generator_checkpoint(init, gen)
    jinst._run()
    inst = tmain.main([*FLAGS, "--init-gen-ckpt", init, "--device", "cpu",
                       "--save-dir", str(tmp / "port"), "--expt-name", "run",
                       "--num-workers", "0", "--device-prefetch", "0"])
    return jinst, inst


def test_pretrain_epoch_losses_match_jax(runs):
    jinst, inst = runs
    jm, tm = _metrics(jinst.config.save_dir), _metrics(inst.config.save_dir)
    for tag in ("GenPreTraining_train_loss", "GenPreTraining_val_loss"):
        want = np.mean([v for _, v in jm[tag]])
        got = np.mean([v for _, v in tm[tag]])
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=tag)
        assert [s for s, _ in tm[tag]] == [s for s, _ in jm[tag]], tag
    assert inst.pretrain_steps == jinst.pretrain_steps == ITEMS // BS


def test_reinforce_epoch_counters_match_jax(runs):
    jinst, inst = runs
    assert inst.config.adv_objective == "reinforce"
    assert inst.state.gen_steps == int(jinst.state.gen_steps) == ITEMS // BS
    assert inst.state.disc_steps == int(jinst.state.disc_steps)
    np.testing.assert_allclose(inst.state.temperature,
                               float(jinst.state.temperature), rtol=1e-6)
    tm = _metrics(inst.config.save_dir)
    assert set(tm) == set(_metrics(jinst.config.save_dir))
    assert all(np.isfinite(v) for rows in tm.values() for _, v in rows)


def test_checkpoints_are_transformer_and_serve(runs):
    _, inst = runs
    adv = os.path.join(inst.config.model_dir, "adv_model.ckpt")
    assert torch.load(adv, weights_only=True)["gen_arch"] == "transformer"
    for name in ("pretrained_model.ckpt", "adv_model.ckpt"):
        service = serve.CaptionService(serve.parse_args(
            ["--checkpoint", os.path.join(inst.config.model_dir, name),
             *FLAGS, "--device", "cpu"]))
        try:
            resp = service.handle_request({"n": 3})
            assert len(resp["captions"]) == 3
            assert all(np.isfinite(resp["logprobs"]))
        finally:
            service.close()


def test_config4_is_the_jax_flag_bundle():
    args = build_parser().parse_args(["--preset", "config4"])
    jargs = get_args(["--preset", "config4"], make_dirs=False)
    for k in ("gen_arch", "disc_arch", "gen_embed_dim", "gen_hidden_dim",
              "gen_num_layers", "gen_num_heads", "disc_embed_dim",
              "disc_hidden_dim", "disc_num_heads", "disc_num_layers",
              "adv_objective", "rollout_num", "rollout_stride", "rl_baseline",
              "pretrain_epochs", "adv_epochs", "dataset_percent",
              "captions_per_image"):
        assert getattr(args, k) == getattr(jargs, k), k
    require_ported_flags(config_from_args(args))


@pytest.mark.parametrize("extra", [["--disc-arch", "bilstm"]])
def test_what_config4_still_lacks_raises(extra, tmp_path):
    args = build_parser().parse_args(["--preset", "config4", *extra])
    with pytest.raises(NotImplementedError):
        require_ported_flags(config_from_args(args))
    with pytest.raises(NotImplementedError):
        tmain.main([*FLAGS, *extra, "--device", "cpu", "--save-dir",
                    str(tmp_path / "s")])
    assert not os.path.exists(tmp_path / "s")


def test_config4_with_gpt2_parses_to_its_geometry():
    """``--preset config4 --gen-arch gpt2``, refused until config5's port:
    the generator takes GPT-2-small's geometry over the preset's widths
    (the JAX ``config_from_args``), and the rest of config4 stays."""
    args = build_parser().parse_args(["--preset", "config4", "--gen-arch",
                                      "gpt2"])
    config = config_from_args(args)
    jconfig = jconfig_from_args(get_args(
        ["--preset", "config4", "--gen-arch", "gpt2"], make_dirs=False))
    for k in ("gen_arch", "gen_embed_dim", "gen_hidden_dim",
              "gen_num_layers", "gen_num_heads", "disc_arch",
              "adv_objective", "rollout_num"):
        assert getattr(config, k) == getattr(jconfig, k), k
    require_ported_flags(config)


def test_config4_conditional_trains(tmp_path):
    """``--preset config4 --conditional-gan 1``, refused until its port:
    the transformer cross-attends over the ResNet grid through MLE and
    REINFORCE epochs, and the adversarial checkpoint is conditional.
    Then serve.py (``{"image"}`` rows carry the grid) and caption.py give
    the same ids and captions of the same val images, the ids differ
    across the images, and the rows decoded without their grid decode
    apart.  That needs captions that follow the image: the reference's
    init sweep (``--gen-init``, the encoder's weights too) leaves the
    eval-mode ResNet's grid the same for every image, so the served
    checkpoint is the trained one with its generator drawn from a seed
    without the sweep (projection N(0, 1): no near-tied argmax)."""
    inst = tmain.main([*FLAGS, "--conditional-gan", "1", "--image-size",
                       "64", "--device", "cpu", "--save-dir",
                       str(tmp_path / "s")])
    assert inst.state.gen.encoder is not None and inst.state.gen_steps > 0
    ckpt = os.path.join(inst.config.model_dir, "adv_model.ckpt")
    obj = torch.load(ckpt, weights_only=True)
    assert obj["conditional"] and obj["gen_arch"] == "transformer"
    _, disc = load_generator_checkpoint(ckpt, inst.config)
    gen = tapi.init_generator(torch.Generator().manual_seed(7), inst.config,
                              sweep=False)
    with torch.no_grad():
        gen.decoder.linear.w.mul_(50.0)
    ckpt = str(tmp_path / "served.ckpt")
    save_generator_checkpoint(ckpt, gen, disc)
    flags = [*FLAGS, "--conditional-gan", "1", "--image-size", "64",
             "--device", "cpu"]
    val = JSynthetic("val", num_items=16, image_size=64, conditional=True,
                     seed=inst.config.seed)
    images = np.stack([val.sample(i)[1] for i in range(4)])
    service = serve.CaptionService(serve.parse_args(
        ["--checkpoint", ckpt, *flags, "--serve-batch-size", "4"]))
    try:
        served = service.caption_images(images)
        served_ids, _ = service.batcher.submit(
            service.features_from_images(images)).result(timeout=60)
        cond, _ = tapi.generator_condition(
            service.config, service.generator,
            {"images": torch.from_numpy(images)})
        bare_ids, bare_lp = tdecode.greedy_with_logprobs(
            service.generator, cond["features"], service.config)
    finally:
        service.close()
    out = tmp_path / "captions.jsonl"
    ids = np.stack(tcaption.main(
        ["--checkpoint", ckpt, *flags, "--num-samples", "4",
         "--pre-eval-batch-size", "4", "--output", str(out)]))
    rows = [json.loads(ln) for ln in open(out)]
    np.testing.assert_array_equal(ids, served_ids)
    assert served["captions"] == [r["caption"] for r in rows]
    np.testing.assert_allclose(served["logprobs"],
                               [r["logprob"] for r in rows], atol=1e-3)
    assert len({tuple(r) for r in ids}) > 1
    assert (not np.array_equal(bare_ids.numpy(), ids)
            or np.abs(bare_lp.numpy() - served["logprobs"]).max() > 1e-3)
