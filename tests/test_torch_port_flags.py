"""Every flag of the JAX package's parsers parses in the port's: the main
parser (``config.build_parser``) and the serve parser (``src/serve.py``)
against the port's.  A JAX command line at the JAX defaults parses and
trains; each flag the port does not honour raises ``NotImplementedError``
when set, the resume, SCST, step-option and batching flags are honoured
(with the JAX help text where it describes the port too), and
``--decode-impl`` maps onto the port's routes."""

import argparse

import pytest

import src.serve as jserve
from gan_image_captioning_tpu.config import build_parser as jbuild_parser
from gan_image_captioning_tpu.config import (
    config_from_args as jconfig_from_args)
from gan_image_captioning_tpu_torch import main as tmain
from gan_image_captioning_tpu_torch import serve as tserve
from gan_image_captioning_tpu_torch.config import (build_parser,
                                                   config_from_args,
                                                   decode_route,
                                                   require_ported_flags)

TINY = ["--dataset", "synthetic", "--synthetic-items", "16",
        "--gen-embed-dim", "8", "--gen-hidden-dim", "8",
        "--gen-num-layers", "1", "--max-seq-len", "5",
        "--disc-embed-dim", "4", "--disc-num-rep", "4",
        "--disc-filter-sizes", "2,3", "--disc-num-filters", "3,3",
        "--pre-train-batch-size", "8", "--pre-eval-batch-size", "8",
        "--adv-train-batch-size", "8", "--adv-eval-batch-size", "8",
        "--pretrain-epochs", "1", "--adv-epochs", "1", "--device", "cpu"]


class _Stop(Exception):
    pass


def _serve_parser(module, monkeypatch, base):
    """The parser a serve module's ``parse_args`` builds, caught before it
    parses."""
    built = []

    def capture():
        parser = base()
        built.append(parser)

        def stop(*args, **kwargs):
            raise _Stop

        parser.parse_args = stop
        return parser

    monkeypatch.setattr(module, "build_parser", capture)
    with pytest.raises(_Stop):
        module.parse_args([])
    return built[0]


def _options(parser):
    return set(parser._option_string_actions)


def test_main_parser_knows_every_jax_option():
    missing = _options(jbuild_parser()) - _options(build_parser())
    assert not missing


def test_serve_parser_knows_every_jax_option(monkeypatch):
    jax_opts = _options(_serve_parser(jserve, monkeypatch, jbuild_parser))
    ours = _options(_serve_parser(tserve, monkeypatch, build_parser))
    assert not jax_opts - ours


def _jax_defaults_argv():
    """Every option of the JAX main parser with its default value (store
    flags left out: naming them sets them)."""
    argv = []
    for action in jbuild_parser()._actions:
        if (not action.option_strings or action.default is None
                or isinstance(action, (argparse._StoreTrueAction,
                                       argparse._HelpAction))):
            continue
        value = action.default
        if isinstance(value, (list, tuple)):
            value = ",".join(str(v) for v in value)
        argv += [action.option_strings[0], str(value)]
    return argv


def test_jax_command_line_at_defaults_parses_and_trains(tmp_path):
    argv = _jax_defaults_argv()
    assert "--disc-engine" in argv and "--zero1" not in argv
    config = config_from_args(build_parser().parse_args(argv))
    require_ported_flags(config)
    assert (config.disc_engine, config.decode_impl) == ("auto", "fused")
    named = ["--disc-engine", "mxu", "--decode-impl", "fused",
             "--tokenizer", "word", "--padding-idx", "0", "--no-jit"]
    inst = tmain.main([*argv, *named, *TINY, "--save-dir",
                       str(tmp_path / "s")])
    assert inst.config.disc_engine == "mxu" and inst.state.gen_steps > 0


# every flag the port parses and refuses when set, with a set value
REFUSED = [("--cp-mode", "ring"), ("--pp-microbatches", "2"),
           ("--zero1", None), ("--encoder-init", "natural")]


# flags that were refused until the conditional transformer and config5
# were ported, and are honoured now
CONFIG5_HONOURED = [("--tokenizer", "bpe"), ("--bpe-vocab", "v.json"),
            ("--bpe-merges", "m.txt"), ("--encoder-arch", "vit"),
            ("--gen-arch", "gpt2")]


@pytest.mark.parametrize("flag,value", CONFIG5_HONOURED)
def test_config5_flags_are_honoured(flag, value):
    config = config_from_args(build_parser().parse_args([flag, value]))
    require_ported_flags(config)
    field = flag[2:].replace("-", "_")
    if flag == "--gen-arch":
        assert (config.gen_arch, config.gen_embed_dim, config.gen_num_layers,
                config.gen_num_heads, config.gen_hidden_dim) == (
                    "transformer", 768, 12, 12, 3072)
    else:
        assert getattr(config, field) == value


@pytest.mark.parametrize("flag,value", REFUSED)
def test_refused_flags_raise_when_set(flag, value):
    argv = [flag] + ([] if value is None else [value])
    config = config_from_args(build_parser().parse_args(argv))
    with pytest.raises(NotImplementedError, match=flag):
        require_ported_flags(config)


# the resume, snapshot, early-stop and SCST flags, honoured since their
# slice: each parses into the config and passes
HONOURED = [("--resume", "x.ckpt", "resume", "x.ckpt"),
            ("--resume", "auto", "resume", "auto"),
            ("--resume-schedule", "0", "resume_schedule", 0),
            ("--checkpoint-every", "2", "checkpoint_every", 2),
            ("--keep-checkpoints", "2", "keep_checkpoints", 2),
            ("--early-stop-patience", "3", "early_stop_patience", 3),
            ("--scst-epochs", "1", "scst_epochs", 1),
            ("--scst-reward", "bleu", "scst_reward", "bleu"),
            ("--scst-multi-ref", None, "scst_multi_ref", True),
            ("--scst-lr", "0.001", "scst_lr", 0.001)]


@pytest.mark.parametrize("flag,value,field,want", HONOURED)
def test_resume_and_scst_flags_are_honoured(flag, value, field, want):
    argv = [flag] + ([] if value is None else [value])
    config = config_from_args(build_parser().parse_args(argv))
    require_ported_flags(config)
    assert getattr(config, field) == want
    jconfig = jconfig_from_args(jbuild_parser().parse_args(argv))
    assert getattr(jconfig, field) == want          # the JAX flag's field


# the step options and batching flags, honoured since their slice: each
# parses into the config field of the JAX flag's name and passes
STEP_OPTIONS = [
    ("--lr-schedule", "cosine", "lr_schedule", "cosine"),
    ("--lr-schedule", "linear", "lr_schedule", "linear"),
    ("--lr-schedule", "exponential", "lr_schedule", "exponential"),
    ("--lr-warmup-steps", "10", "lr_warmup_steps", 10),
    ("--lr-decay-steps", "100", "lr_decay_steps", 100),
    ("--lr-min-ratio", "0.1", "lr_min_ratio", 0.1),
    ("--ema-decay", "0.999", "ema_decay", 0.999),
    ("--grad-accum", "2", "grad_accum", 2),
    ("--skip-nonfinite-grads", "1", "skip_nonfinite_grads", 1),
    ("--debug-nans", None, "debug_nans", True),
    ("--mle-objective", "scheduled", "mle_objective", "scheduled"),
    ("--ss-max-prob", "0.5", "ss_max_prob", 0.5),
    ("--use-pallas", "off", "use_pallas", "off"),
    ("--use-pallas", "on", "use_pallas", "on"),
    ("--steps-per-call", "4", "steps_per_call", 4),
    ("--length-buckets", "12,24", "length_buckets", "12,24"),
    ("--precollate", "on", "precollate", "on"),
    ("--precollate", "off", "precollate", "off"),
    ("--profile-dir", "prof", "profile_dir", "prof")]


@pytest.mark.parametrize("flag,value,field,want", STEP_OPTIONS)
def test_step_option_flags_are_honoured(flag, value, field, want):
    argv = [flag] + ([] if value is None else [value])
    if flag == "--lr-schedule":
        argv += ["--lr-decay-steps", "10"] + (
            ["--lr-min-ratio", "0.5"] if value == "exponential" else [])
    config = config_from_args(build_parser().parse_args(argv))
    require_ported_flags(config)
    assert getattr(config, field) == want
    jconfig = jconfig_from_args(jbuild_parser().parse_args(argv))
    assert getattr(jconfig, field) == want          # the JAX flag's field
    jhelp = {a.dest: a.help for a in jbuild_parser()._actions}
    ours = {a.dest: a.help for a in build_parser()._actions}
    assert "not ported" not in ours[field] and ours[field]
    if field in ("lr_schedule", "lr_warmup_steps", "lr_decay_steps",
                 "lr_min_ratio", "skip_nonfinite_grads", "ss_max_prob",
                 "mle_objective", "length_buckets"):
        assert ours[field] == jhelp[field]          # the JAX text


@pytest.mark.parametrize("argv", [
    ["--vocab-size", "99"], ["--padding-idx", "1"], ["--device-ids", "1"],
    ["--test-log-step", "5"], ["--no-jit"], ["--decode-impl", "kernel"],
    ["--decode-impl", "decoupled"], ["--length-penalty", "0.6"]] + [
    ["--disc-engine", e] for e in ("auto", "xla", "pallas", "hybrid", "mxu")])
def test_accepted_flags_pass(argv):
    config = config_from_args(build_parser().parse_args(argv))
    require_ported_flags(config)
    if argv[0] == "--length-penalty":
        assert config.length_penalty == 0.6


def test_decode_impl_maps_onto_the_port_routes():
    config = config_from_args(build_parser().parse_args([]))
    assert decode_route(config) == "kernel"
    routes = {impl: decode_route(config.replace(decode_impl=impl))
              for impl in ("fused", "kernel", "decoupled", "kernel_rescore",
                           "kernel_embed", "plain")}
    assert routes == {"fused": "kernel", "kernel": "kernel",
                      "decoupled": "decoupled",
                      "kernel_rescore": "kernel_rescore",
                      "kernel_embed": "kernel_embed", "plain": "plain"}
    with pytest.raises(ValueError):
        decode_route(config.replace(decode_impl="scan"))


SERVE_REFUSED = [("--exported", "m.gic")]
# serve flags that were refused until the serving slice ported them: each
# parses to its value (what each does: test_torch_port_serve_http.py)
SERVE_HONOURED = [("--http-port", "8080", 8080), ("--serve-watch", "5", 5.0),
                  ("--decode-mode", "speculative", "speculative"),
                  ("--draft-len", "2", 2)]


@pytest.mark.parametrize("flag,value", SERVE_REFUSED)
def test_refused_serve_flags_raise_when_set(flag, value):
    with pytest.raises(NotImplementedError, match=flag):
        tserve.parse_args(["--init-seed", "0", flag, value])


@pytest.mark.parametrize("flag,value,parsed", SERVE_HONOURED)
def test_honoured_serve_flags_parse(flag, value, parsed):
    args = tserve.parse_args(["--init-seed", "0", flag, value])
    assert getattr(args, flag[2:].replace("-", "_")) == parsed


# every decode mode the port serves, and each sampling knob: (mode, more
# flags, the service's resolved mode)
SERVE_MODES = [
    pytest.param("auto", [], "greedy", id="auto"),
    pytest.param("greedy", [], "greedy", id="greedy"),
    pytest.param("beam", ["--beam-size", "3"], "beam", id="beam"),
    pytest.param("sample", [], "sample", id="sample"),
    pytest.param("sample", ["--top-k", "5"], "sample", id="top-k"),
    pytest.param("sample", ["--top-p", "0.9"], "sample", id="top-p"),
    pytest.param("sample", ["--sample-temperature", "0.7"], "sample",
                 id="sample-temperature"),
    pytest.param("sample", ["--repetition-penalty", "1.2"], "sample",
                 id="repetition-penalty"),
    pytest.param("sample", ["--no-repeat-ngram", "2"], "sample",
                 id="no-repeat-ngram"),
    pytest.param("beam", ["--beam-size", "2", "--min-length", "3"], "beam",
                 id="min-length"),
    pytest.param("sample", ["--sample-seed", "1"], "sample",
                 id="sample-seed")]


@pytest.mark.parametrize("mode,extra,resolved", SERVE_MODES)
def test_greedy_decode_modes_serve(mode, extra, resolved):
    """Each decode mode and knob parses, reaches the service and answers
    (the mode and knobs against the JAX package's decodes:
    ``test_torch_port_{beam,sample_decode,evaluate}.py``)."""
    args = tserve.parse_args(["--init-seed", "0", "--decode-mode", mode,
                              "--device", "cpu", "--dataset", "synthetic",
                              "--gen-embed-dim", "8", "--gen-hidden-dim",
                              "8", "--max-seq-len", "5", *extra])
    service = tserve.CaptionService(args)
    try:
        assert service.mode == resolved
        for flag, value in zip(extra[::2], extra[1::2]):
            dest = flag[2:].replace("-", "_")
            assert str(getattr(args, dest)) == value
        out = service.handle_request({"n": 2})
        assert len(out["captions"]) == 2
        if "--min-length" in extra:
            assert all(len(c.split()) >= 3 for c in out["captions"])
    finally:
        service.close()
