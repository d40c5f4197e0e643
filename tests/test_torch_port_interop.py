"""The weights bridge and the reference-layout checkpoints: a JAX param
tree through ``params_from_jax``, and a state_dict written by the JAX
package's ``models/torch_export.generator_to_torch`` (what
``src/export_torch.py`` saves), give the same port decode."""

import jax
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.models import generator as jgen
from gan_image_captioning_tpu.models.torch_export import generator_to_torch
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.eval import decode as tdecode
from gan_image_captioning_tpu_torch.interop import (generator_from_jax,
                                                    params_from_jax)
from gan_image_captioning_tpu_torch.train.checkpoint import (
    load_generator_checkpoint, save_generator_checkpoint)

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

T, V, H, E = 8, 128, 16, 16
KW = dict(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H, gen_num_layers=2,
          max_seq_len=T - 2)


@pytest.fixture(scope="module")
def gen_params():
    dec = jgen.init_decoder_params(jax.random.PRNGKey(2), JConfig(**KW))
    return jax.tree_util.tree_map(np.asarray, {"decoder": dec})


def _decode(gen):
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, E)).astype(np.float32))
    return tdecode.greedy_with_logprobs(gen, feats, Config(**KW))


def test_bridge_matches_torch_export(gen_params):
    ours = params_from_jax(gen_params)
    ref = generator_to_torch(gen_params)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    # the decoder dict alone is accepted as well
    assert params_from_jax(gen_params["decoder"]).keys() == ref.keys()


@pytest.mark.parametrize("form", ["plain", "adv"])
def test_exported_checkpoint_decodes_like_the_bridge(tmp_path, gen_params,
                                                     form):
    sd = generator_to_torch(gen_params)
    disc = {"embeddings.weight": torch.zeros(4, V)}
    path = str(tmp_path / "gen.ckpt")
    torch.save(sd if form == "plain" else {"generator": sd,
                                           "discriminator": disc}, path)
    gen, disc_loaded = load_generator_checkpoint(path, Config(**KW))
    assert (disc_loaded is None) == (form == "plain")
    ids, lp = _decode(gen)
    ids_b, lp_b = _decode(generator_from_jax(gen_params, Config(**KW)))
    assert torch.equal(ids, ids_b) and torch.equal(lp, lp_b)


def test_save_load_round_trip(tmp_path, gen_params):
    gen = generator_from_jax(gen_params, Config(**KW))
    path = str(tmp_path / "rt.ckpt")
    save_generator_checkpoint(path, gen)
    back, _ = load_generator_checkpoint(path, Config(**KW))
    for (k, a), (k2, b) in zip(gen.state_dict().items(),
                               back.state_dict().items()):
        assert k == k2 and torch.equal(a, b)
    assert set(torch.load(path, weights_only=True)) == set(
        generator_to_torch(gen_params))


def test_load_rejects_other_geometry_and_missing_files(tmp_path, gen_params):
    path = str(tmp_path / "g.ckpt")
    torch.save(generator_to_torch(gen_params), path)
    with pytest.raises(RuntimeError):
        load_generator_checkpoint(path, Config(**dict(KW, vocab_size=2 * V)))
    with pytest.raises(FileNotFoundError):
        load_generator_checkpoint(str(tmp_path / "none.ckpt"), Config(**KW))
