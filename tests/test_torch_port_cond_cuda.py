"""The ``image_norm`` kernel against its plain version, and the conditional
training path through it, on the card.  Every test skips without CUDA.
This file imports torch and the port only, so it runs on a machine
without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cond_cuda.py

Tolerances: the kernel within 1e-6 of the plain version (both round the
product and the sum once each, so they are bit-equal in practice); a
conditional step through the kernels within 1e-4 of the plain route's
loss.
"""

import os

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu_torch import main as tmain
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.loader import make_batch
from gan_image_captioning_tpu_torch.kernels import image_norm as inorm
from gan_image_captioning_tpu_torch.train import steps as tsteps
from gan_image_captioning_tpu_torch.train.state import create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6
# the full-width batch, the odd plane (H*W % 4 == 1), a one-pixel plane,
# a plane of H*W % 4 == 2
SHAPES = [(64, 3, 256, 256), (3, 3, 37, 37), (4, 3, 1, 1), (1, 3, 5, 130)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _u8(shape, seed, device):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, shape, dtype=np.uint8)).to(device)


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(device, shape):
    u8 = _u8(shape, sum(shape), device)
    before = inorm.normalize_images.launches
    out = inorm.normalize_images(u8)
    torch.cuda.synchronize()
    assert inorm.normalize_images.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == u8.shape
    want = inorm.normalize_images_plain(u8)
    torch.testing.assert_close(out, want, atol=ATOL, rtol=0)


def test_kernel_on_a_misaligned_view_matches_plain(device):
    """A view at an odd byte offset takes the scalar kernel."""
    flat = _u8((3 * 3 * 37 * 37 + 1,), 5, device)
    u8 = flat[1:].view(3, 3, 37, 37)
    assert u8.is_contiguous() and u8.data_ptr() % 4 != 0
    out = inorm.normalize_images(u8)
    torch.testing.assert_close(out, inorm.normalize_images_plain(u8),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("make,err", [
    (lambda d: torch.zeros(2, 3, 4, 4, device=d), TypeError),
    (lambda d: torch.zeros(2, 4, 4, 4, dtype=torch.uint8, device=d),
     ValueError),
    (lambda d: torch.zeros(3, 4, 4, dtype=torch.uint8, device=d), ValueError),
    (lambda d: torch.zeros(2, 4, 4, 3, dtype=torch.uint8,
                           device=d).permute(0, 3, 1, 2), ValueError)])
def test_malformed_cuda_calls_raise_and_launch_nothing(device, make, err):
    before = inorm.normalize_images.launches
    with pytest.raises(err):
        inorm.normalize_images(make(device))
    with pytest.raises(TypeError):   # float32 and bfloat16 only
        inorm.normalize_images(_u8((1, 3, 2, 2), 0, device), torch.float16)
    assert inorm.normalize_images.launches == before


KW = dict(vocab_size=40, gen_embed_dim=16, gen_hidden_dim=16,
          gen_num_layers=2, max_seq_len=6, disc_embed_dim=8, disc_num_rep=4,
          disc_filter_sizes=(2, 3), disc_num_filters=(5, 6),
          conditional_gan=1, image_size=32)


def _batch(config, device, B=4):
    rng = np.random.default_rng(0)
    caps = [rng.integers(4, 40, size=4) for _ in range(B)]
    imgs = [rng.integers(0, 256, (3, 32, 32)).astype(np.uint8)
            for _ in range(B)]
    return tsteps.batch_to(make_batch(caps, imgs, config.seq_len), device)


@pytest.mark.parametrize("kind", ["mle_free", "mle_teacher", "adv"])
def test_conditional_step_launches_image_norm(device, kind):
    objective = "teacher" if kind == "mle_teacher" else "free"
    config = Config(**KW, mle_objective=objective)
    batch = _batch(config, device)
    assert batch["images_u8"].is_cuda
    losses = {}
    for route in ("kernel", "plain"):
        cfg = config if route == "kernel" else config.replace(
            image_norm_impl="plain", decode_impl="plain", disc_engine="plain")
        state = create_train_state(cfg, 0, device, sweep=False)
        before = inorm.normalize_images.launches
        if kind == "adv":
            noise = {"uniforms": torch.rand(
                (config.seq_len, 4, 40),
                generator=torch.Generator(device=device).manual_seed(1),
                device=device)}
            _, m = tsteps.make_adv_step(cfg)(state, batch, 2.0, noise)
            losses[route] = float(m["gen_adv_loss"])
        else:
            _, m = tsteps.make_mle_step(cfg)(state, batch)
            losses[route] = float(m["gen_pretrain_loss"])
        torch.cuda.synchronize()
        assert inorm.normalize_images.launches == before + (
            route == "kernel"), route
    np.testing.assert_allclose(losses["kernel"], losses["plain"], rtol=1e-4)


FLAGS = ["--conditional-gan", "1", "--image-size", "32",
         "--gen-embed-dim", "16", "--gen-hidden-dim", "16",
         "--max-seq-len", "6", "--disc-num-rep", "4",
         "--disc-filter-sizes", "2,3", "--disc-num-filters", "5,6",
         "--pre-train-batch-size", "8", "--pre-eval-batch-size", "8",
         "--adv-train-batch-size", "8", "--adv-eval-batch-size", "8",
         "--pretrain-epochs", "1", "--adv-epochs", "1"]


def test_main_runs_on_the_card_by_default(device, tmp_path):
    inst = tmain.main([*FLAGS, "--dataset", "synthetic",
                       "--synthetic-items", "16",
                       "--save-dir", str(tmp_path)])
    assert inst.device.type == "cuda"
    assert next(inst.state.gen.parameters()).is_cuda
    assert inst.pretrain_steps == 2 and inst.state.gen_steps == 2
    assert os.path.isfile(os.path.join(inst.config.model_dir,
                                       "adv_model.ckpt"))


def test_main_on_device_preprocessed_coco_launches_image_norm(device,
                                                              tmp_path):
    pytest.importorskip("PIL", reason="decoding the COCO JPEGs needs Pillow")
    before = inorm.normalize_images.launches
    inst = tmain.main([*FLAGS, "--dataset", "coco", "--data-dir",
                       os.path.join(REPO, "data", "mini_coco"),
                       "--captions-per-image", "5", "--device-preprocess",
                       "1", "--save-dir", str(tmp_path)])
    # one launch per train and eval batch of both phases
    loaders = (inst.pre_train_loader, inst.pre_eval_loader,
               inst.adv_train_loader, inst.adv_eval_loader)
    assert inorm.normalize_images.launches - before == sum(
        len(loader) for loader in loaders)
