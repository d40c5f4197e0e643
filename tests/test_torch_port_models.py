"""The port's flags, initializers and unconditional conditioning against
the JAX package's (``config.py``, ``ops/initializers.py``,
``models/generator.py:init_decoder_params``, ``models/api.py``)."""

import jax
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.config import build_parser as jbuild_parser
from gan_image_captioning_tpu.models import api as japi
from gan_image_captioning_tpu.models import generator as jgen
from gan_image_captioning_tpu_torch.config import (Config, build_parser,
                                                   padded_vocab_size)
from gan_image_captioning_tpu_torch.interop import generator_from_jax
from gan_image_captioning_tpu_torch.models import api as tapi
from gan_image_captioning_tpu_torch.models import generator as tgen
from gan_image_captioning_tpu_torch.ops.initializers import init_param_tree

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

V, E, H = 64, 48, 32
KW = dict(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H, gen_num_layers=2,
          max_seq_len=6)


def _stds(module):
    return {k: float(v.std()) for k, v in module.state_dict().items()
            if v.ndim == 2}


def test_modules_are_allocated_on_the_cpu_by_default():
    gen = tgen.Generator(Config(**KW))
    assert {p.device.type for p in gen.parameters()} == {"cpu"}


def test_flags_have_the_jax_names_and_defaults():
    ours = {a.dest: a.default for a in build_parser()._actions
            if a.dest != "help"}
    theirs = {a.dest: a.default for a in jbuild_parser()._actions}
    assert set(ours) <= set(theirs)
    assert {k: theirs[k] for k in ours} == ours


def test_vocab_padding_matches_inject_vocab_size():
    from src.main import inject_vocab_size

    class Args:
        vocab_multiple = 11008

    class Data:
        vocab_size = 35

    assert padded_vocab_size(35, 11008) == inject_vocab_size(
        Args(), Data()).vocab_size == 11008
    assert padded_vocab_size(35, 1) == 35


def test_generator_condition_matches_jax():
    params = {"decoder": jgen.init_decoder_params(jax.random.PRNGKey(0),
                                                  JConfig(**KW))}
    gen = generator_from_jax(jax.tree_util.tree_map(np.asarray, params),
                             Config(**KW))
    want, _ = japi.generator_condition(
        JConfig(**KW), params, {"captions": np.zeros((3, 8), np.int32)},
        train=False)
    got, stats = tapi.generator_condition(
        Config(**KW), gen, {"captions": torch.zeros(3, 8)})
    assert stats is None and got["context"] is None
    np.testing.assert_array_equal(got["features"].detach().numpy(),
                                  np.asarray(want["features"]))


def test_init_decoder_params_match_jax_distributions():
    ours = tgen.Decoder(Config(**KW))
    tgen.init_decoder_params(torch.Generator().manual_seed(0), ours)
    theirs = jgen.init_decoder_params(jax.random.PRNGKey(0), JConfig(**KW))
    np.testing.assert_allclose(float(ours.embed.weight.detach().std()),
                               float(np.std(theirs["embed"])), rtol=0.1)
    np.testing.assert_allclose(float(ours.linear.weight.detach().std()),
                               float(np.std(theirs["linear"]["w"])), rtol=0.1)
    assert not ours.linear.bias.any()
    bound = 1 / np.sqrt(H)
    for p in ours.lstm.parameters():
        assert float(p.detach().abs().max()) <= bound


@pytest.mark.parametrize("strategy", ["uniform", "normal"])
def test_init_sweep_matches_jax_distributions(strategy):
    gen = tgen.Generator(Config(**KW))
    init_param_tree(torch.Generator().manual_seed(1), gen, strategy)
    params = {"decoder": jgen.init_decoder_params(jax.random.PRNGKey(1),
                                                  JConfig(**KW))}
    swept = jgen.init_param_tree(jax.random.PRNGKey(2), params, strategy)
    theirs = generator_from_jax(jax.tree_util.tree_map(np.asarray, swept),
                                Config(**KW))
    ours, want = _stds(gen), _stds(theirs)
    assert ours.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(ours[k], want[k], rtol=0.15, err_msg=k)
    if strategy == "uniform":
        assert max(float(p.detach().abs().max())
                   for p in gen.parameters()) <= 0.05


def test_init_sweep_is_seeded_and_skips_on_request():
    def swept(seed, skip=None):
        gen = tgen.Generator(Config(**KW))
        tgen.init_decoder_params(torch.Generator().manual_seed(0),
                                 gen.decoder)
        return init_param_tree(torch.Generator().manual_seed(seed), gen,
                               "uniform", skip_predicate=skip)

    a, b, c = swept(3), swept(3), swept(4)
    for (k, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(x, y) and not torch.equal(x, z), k
    kept = swept(3, skip=lambda name, p: name.endswith("embed.weight"))
    assert float(kept.decoder.embed.weight.detach().abs().max()) > 0.05
    assert init_param_tree(None, b, "none") is b
