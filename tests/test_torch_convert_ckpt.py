"""The port's checkpoint converter (``real3dportrait_tpu_torch/tools/
convert_torch_ckpt.py``) against the JAX package's (``tools/
convert_torch_ckpt.py``) on the CPU, on state dicts in the released torch
layout that ``tests/_torch_ref_layout.py`` writes from seeded port modules
at tiny widths:

(a) the layout writer is sound: the JAX converter on its state dict gives
    a tree that ``verify_tree`` finds equal in names and shapes to the JAX
    module's init tree, with every leaf the module's (bit-equal, or within
    the fold's stated bound where the converter folds a norm);
(b) the port's converter gives the JAX converter's tree, family by family:
    the same keys, dtypes, shapes and bytes;
(c) both command lines write byte-equal files, from a file and from a
    directory;
(d) the port's pipeline loaded from the port-converted directories renders
    the JAX pipeline's frames from the JAX-converted ones;
(e) the port's command line runs with JAX and Flax blocked;
(f) ``fit_to_template``'s strict and lenient fits match the JAX one's;
and the port's parity tool converts ``--torch_a2m`` / ``--torch_s2v`` as
the JAX tool does."""

import copy
import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.audio import hubert as jhub
from real3dportrait_tpu.config import load_config as jax_load_config
from real3dportrait_tpu.inference import pipeline as jpipe
from real3dportrait_tpu.metrics import inception as jinc
from real3dportrait_tpu.models import perceptual as jperc
from real3dportrait_tpu.models import stylegan2 as jsg
from real3dportrait_tpu.models import superresolution as jsr
from real3dportrait_tpu.models import syncnet as jsync
from real3dportrait_tpu_torch import config as port_config
from real3dportrait_tpu_torch.audio.hubert import HubertEncoder
from real3dportrait_tpu_torch.inference import pipeline as pipe_mod
from real3dportrait_tpu_torch.metrics.inception import InceptionV3Features
from real3dportrait_tpu_torch.models import perceptual as perc
from real3dportrait_tpu_torch.models.stylegan2 import Discriminator, Generator, MappingNetwork
from real3dportrait_tpu_torch.models.superresolution import SuperresolutionHybrid8XDC
from real3dportrait_tpu_torch.models.syncnet import LandmarkHubertSyncNet
from real3dportrait_tpu_torch.tools import convert_torch_ckpt as conv
from real3dportrait_tpu_torch.tools import eval_parity
from real3dportrait_tpu_torch.weights import (
    jax_variables_from_torch,
    load_jax_variables,
    mock_init_,
    torch_state_dict_from_jax,
)
from tests import _torch_ref_layout as ref_layout
from tests._torch_parity import agree
from tests.test_torch_audio import chirp_wav
from tests.test_torch_run import ROOT, SMALL
from tools import convert_torch_ckpt as jconv

torch.set_num_threads(1)

ORIG = os.path.join(ROOT, "configs", "real3d_orig.yaml")
DEFAULT = os.path.join(ROOT, "configs", "secc_img2plane_torso.yaml")
# the released geometry at the tiny widths, the composite backbone cut to
# its small depth
TINY = dict({k: v for k, v in SMALL.items() if k != "sampling_preset"},
            img2plane_backbone_scale="small")
SEGFORMER = dict(TINY, img2plane_backbone_mode="segformer", img2plane_backbone_scale="b0",
                 head_norm_mode="folded_bn")
HUBERT = dict(hidden=128, layers=2, heads=2, ffn=256, conv_dims=(32, 32, 32),
              conv_kernels=(10, 3, 2), conv_strides=(5, 2, 2), pos_conv_kernel=16,
              pos_conv_groups=4)
HUBERT_GROUP = dict(HUBERT, feat_extract_norm="group", do_stable_layer_norm=False)
KEYS = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}


def assert_same_tree(got, want, path="tree"):
    """The same nested keys, and leaves of the same type, dtype, shape and
    bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (
            path, sorted(set(got) ^ set(want))[:5])
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
        return
    assert type(got) is type(want), (path, type(got), type(want))
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
    assert got.tobytes() == want.tobytes(), path


def _jax_shell(config: str, overrides: dict, use_torso: bool = True):
    """The JAX pipeline's models, no weights."""
    cfg = jax_load_config(config, overrides)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe.Real3DPortraitPipeline, "_init_weights", lambda *a: None)
        return jpipe.Real3DPortraitPipeline(cfg, use_torso=use_torso, mock_weights=True, seed=0)


def _jax_model_template(shell) -> dict:
    res = shell.res
    cam = jnp.concatenate([jnp.eye(4).reshape(1, 16), jnp.eye(3).reshape(1, 9)], -1)
    kwargs = {"secc": jnp.zeros((1, res, res, 9))}
    if shell.use_torso:
        kwargs["cond"] = shell._mock_cond(np.zeros((res, res, 3), np.float32))
    return dict(jax.eval_shape(lambda: shell.model.init(
        KEYS, jnp.zeros((1, res, res, 3)), cam, **kwargs)))


def _jax_a2m_template(shell) -> dict:
    batch = {"audio": jnp.zeros((1, 32, shell.audio_in_dim)), "f0": jnp.zeros((1, 32)),
             "y_mask": jnp.ones((1, 16)), "blink": jnp.zeros((1, 32, 1), jnp.int32),
             "y": jnp.zeros((1, 16, 64))}
    return {"params": jax.eval_shape(lambda: shell.a2m.init(KEYS, batch, train=True))["params"]}


def _init_template(module, *args) -> dict:
    return dict(jax.eval_shape(lambda: module.init(KEYS, *args)))


def _seeded(module, seed: int):
    return mock_init_(module, torch.Generator().manual_seed(seed)).eval()


def _pipeline_family(built, config, overrides, use_torso, backbone):
    if (config, use_torso) == (ORIG, True):  # the command lines' pipeline
        model = orig_pipeline(built).model
    else:
        cfg = port_config.load_config(config, overrides)
        model = _seeded(pipe_mod.build_model(cfg, use_torso), 3)
    ref = ref_layout.secc2video(model, seed=4, backbone_mode=backbone)
    template = _jax_model_template(_jax_shell(config, overrides, use_torso))
    return model, ref, lambda sd: _drop_extra(conv.convert_secc2video(sd, backbone)), \
        lambda sd: _drop_extra(jconv.convert_secc2video(sd, backbone)), template


def _drop_extra(tree):
    extra = tree.pop("task_extra")
    assert sorted(extra) == ["lambda_pertube_blink_secc", "lambda_pertube_secc"]
    assert all(v.shape == () and v.dtype == np.float32 for v in extra.values())
    return tree


def _a2m_family(built):
    a2m = orig_pipeline(built).a2m
    return a2m, ref_layout.audio2secc(a2m, seed=6), conv.convert_audio2secc, \
        jconv.convert_audio2secc, _jax_a2m_template(_jax_shell(ORIG, TINY))


def _module_family(module, ref_fn, name, jax_module, *init_args):
    return module, ref_fn(module, seed=7), getattr(conv, name), getattr(jconv, name), \
        _init_template(jax_module, *init_args)


def _tree_family(init_port, init_jax, layout, name):
    """The perceptual trees: the port's seeded tree is the module."""
    tree = init_port()
    return tree, layout(tree), getattr(conv, name), getattr(jconv, name), \
        jax.tree.map(np.asarray, init_jax())


GEN = dict(z_dim=16, c_dim=0, w_dim=24, img_resolution=32, img_channels=3, mapping_layers=2,
           channel_base=1024, channel_max=64)
DISC = dict(c_dim=8, img_resolution=32, img_channels=3, channel_base=1024, channel_max=64,
            num_fp16_res=0, mbstd_group_size=2, mapping_layers=2)
SR = dict(w_dim=24, input_resolution=16, block0_channels=16, block1_channels=8,
          final_resolution=64, sr_num_fp16_res=0)
SYNC = dict(lm_dim=60, num_layers_per_block=3, base_hid_size=16, out_dim=32, norm_mode="affine")

FAMILIES = {
    "secc2video_composite": lambda b: _pipeline_family(b, ORIG, TINY, True, "composite"),
    "secc2video_segformer": lambda b: _pipeline_family(b, DEFAULT, SEGFORMER, True,
                                                       "segformer"),
    "secc2video_head_only": lambda b: _pipeline_family(b, ORIG, TINY, False, "composite"),
    "audio2secc": _a2m_family,
    "stylegan2_generator": lambda b: _module_family(
        _seeded(Generator(**GEN), 8), ref_layout.stylegan, "convert_stylegan2_generator",
        jsg.Generator(**GEN), jnp.zeros((1, 16)), None),
    "stylegan2_discriminator": lambda b: _module_family(
        _seeded(Discriminator(**DISC), 9), ref_layout.discriminator,
        "convert_stylegan2_discriminator", jsg.Discriminator(**DISC),
        jnp.zeros((2, 32, 32, 3)), jnp.zeros((2, 8))),
    "mapping_network": lambda b: _module_family(
        _seeded(MappingNetwork(12, 24, num_layers=3, z_dim=16, num_ws=5), 10),
        ref_layout.stylegan, "convert_mapping_network",
        jsg.MappingNetwork(z_dim=16, c_dim=12, w_dim=24, num_ws=5, num_layers=3),
        jnp.zeros((1, 16)), jnp.zeros((1, 12))),
    "superresolution_8xdc": lambda b: _module_family(
        _seeded(SuperresolutionHybrid8XDC(32, **SR), 11), ref_layout.stylegan,
        "convert_superresolution", jsr.SuperresolutionHybrid8XDC(**SR),
        jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 16, 16, 32)), jnp.zeros((1, 3, 24))),
    "syncnet": lambda b: _module_family(
        _seeded(LandmarkHubertSyncNet(**SYNC), 12), ref_layout.syncnet, "convert_syncnet",
        jsync.LandmarkHubertSyncNet(**SYNC), jnp.zeros((1, 10, 1024)), jnp.zeros((1, 5, 60))),
    "vgg19": lambda b: _tree_family(perc.init_vgg19_params, jperc.init_vgg19_params,
                                  ref_layout.vgg19, "convert_vgg19"),
    "vggface": lambda b: _tree_family(perc.init_vggface_params, jperc.init_vggface_params,
                                    ref_layout.vggface, "convert_vggface"),
    "lpips_vgg": lambda b: _tree_family(perc.init_lpips_params, jperc.init_lpips_params,
                                      ref_layout.lpips_vgg, "convert_lpips_vgg"),
    **{f"hubert_{norm}_{wn}": (lambda b, kw=kw, par=wn == "parametrizations": _module_family(
        _seeded(HubertEncoder(**kw), 13),
        lambda m, seed: ref_layout.hubert(m, seed, parametrizations=par), "convert_hubert",
        jhub.HubertEncoder(**kw), jnp.zeros((1, 2000))))
       for norm, kw in (("layer", HUBERT), ("group", HUBERT_GROUP))
       for wn in ("weight_g", "parametrizations")},
    "inception": lambda b: _module_family(
        _seeded(InceptionV3Features(), 14), ref_layout.inception, "convert_inception",
        jinc.InceptionV3Features(), jnp.zeros((1, 75, 75, 3))),
}


@pytest.fixture(scope="module")
def built():
    """The families and the tiny released-geometry pipeline, each built at
    its first use in this module's run."""
    return {}


def orig_pipeline(built: dict):
    """The tiny released-geometry pipeline (seeded weights)."""
    if "pipeline" not in built:
        built["pipeline"] = pipe_mod.Real3DPortraitPipeline(
            port_config.load_config(ORIG, TINY), device="cpu", seed=0)
    return built["pipeline"]


def family(built: dict, name: str):
    """(port module or tree, RefLayout or released state dict, the port's
    converter, the JAX converter, the JAX init tree)."""
    if name not in built:
        built[name] = FAMILIES[name](built)
    return built[name]


def _state_dict(ref):
    return ref.state_dict if isinstance(ref, ref_layout.RefLayout) else ref


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_jax_converter_takes_the_layout_writers_state_dicts(built, name):
    # (a): names and shapes equal to the JAX init tree, no extra; every
    # leaf the module's, bit-equal, or within its fold's bound
    module, ref, _, jax_convert, template = family(built, name)
    tree = jax_convert(dict(_state_dict(ref)))
    assert conv.verify_tree(tree, template) == []
    if isinstance(module, dict):  # a perceptual tree: every leaf copied
        assert_same_tree(jax.tree.map(np.asarray, tree), jax.tree.map(np.asarray, module))
        return
    got = ref_layout.check_converted(module, ref, torch_state_dict_from_jax(tree))
    assert got["equal"] > 0 and got["folded"] == len(ref.bounds), got


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_port_converter_gives_the_jax_converters_tree(built, name):
    # (b): the same keys, dtypes, shapes and bytes on the same state dict
    _, ref, port_convert, jax_convert, _ = family(built, name)
    sd = _state_dict(ref)
    assert_same_tree(port_convert(dict(sd)), jax_convert(dict(sd)))


def test_a_converted_tree_missing_or_misshaping_a_key_raises_naming_it(built):
    # no fallback: a released state dict without a tensor, or with one of
    # another shape, converts; the strict loader then raises, naming the
    # port's parameter
    model, ref, port_convert, _, _ = family(built, "secc2video_head_only")
    sd = dict(ref.state_dict)
    del sd["decoder.net.0.bias"]
    with pytest.raises(RuntimeError, match='Missing key.*"decoder.net0.bias"'):
        load_jax_variables(copy.deepcopy(model), port_convert(sd))
    a2m, ref, port_convert, _, _ = family(built, "audio2secc")
    sd = dict(ref.state_dict)
    sd["blink_embed.weight"] = sd["blink_embed.weight"][..., None]
    with pytest.raises(RuntimeError, match="size mismatch for blink_embed.weight"):
        load_jax_variables(copy.deepcopy(a2m), port_convert(sd))


# -- the command lines and the pipelines -------------------------------------------


@pytest.fixture(scope="module")
def released(tmp_path_factory, built):
    """The tiny released-geometry pipeline's weights (seeded) as reference
    ``.ckpt`` files, by name (``global_step`` gives the step) and in
    directories (the file name gives it)."""
    root = tmp_path_factory.mktemp("released")
    pipe = orig_pipeline(built)
    a2m, s2v = family(built, "audio2secc")[1], family(built, "secc2video_composite")[1]
    for d in ("a2m_dir", "s2v_dir"):
        os.makedirs(root / d)
    a2m.save(str(root / "a2m.ckpt"), 120)
    s2v.save(str(root / "s2v.ckpt"), 340)
    os.link(root / "a2m.ckpt", root / "a2m_dir" / "model_ckpt_steps_7.ckpt")
    os.link(root / "s2v.ckpt", root / "s2v_dir" / "model_ckpt_steps_9.ckpt")
    yield dict(root=root, pipe=pipe, a2m=a2m, s2v=s2v,
               file=[str(root / "a2m.ckpt"), str(root / "s2v.ckpt")],
               dir=[str(root / "a2m_dir"), str(root / "s2v_dir")])
    shutil.rmtree(root)  # ~2 GB of checkpoints and converted files


def _convert(main, inputs, out) -> str:
    """``main`` on the two inputs; its log with ``out`` written <out>."""
    log = io.StringIO()
    with redirect_stdout(log):
        main(["--audio2secc", inputs[0], "--secc2video", inputs[1], "--out", str(out)])
    return log.getvalue().replace(str(out), "<out>")


def _files(root) -> dict:
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.mark.parametrize("form,steps", [("file", (120, 340)), ("dir", (7, 9))])
def test_both_command_lines_write_the_same_bytes(released, form, steps):
    # (c): the same files, byte for byte, and the same log lines
    root = released["root"]
    port_log = _convert(conv.main, released[form], root / f"port_{form}")
    jax_log = _convert(jconv.main, released[form], root / f"jax_{form}")
    assert port_log == jax_log
    got, want = _files(root / f"port_{form}"), _files(root / f"jax_{form}")
    assert sorted(got) == sorted(want) == [
        f"audio2secc/model_ckpt_steps_{steps[0]}.ckpt",
        f"secc2video/model_ckpt_steps_{steps[1]}.ckpt"]
    for k in want:
        assert got[k] == want[k], k


def _zeros_init():
    """A Flax ``Module.init`` that gives zeros on the init tree's shapes:
    the checkpoints replace them."""
    real_init = nn.Module.init

    def init(self, rngs, *args, **kwargs):
        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
            lambda: real_init(self, rngs, *args, **kwargs)))
    return init


def test_port_pipeline_from_port_converted_renders_the_jax_frames(released):
    # (d): the port's pipeline from the port's files, the JAX pipeline from
    # JAX's (their seeded weights replaced), the tiny run from 0.32 s of wav
    # at temperature 0: 3e-2 / 3e-3 of scale, the tolerance of the frames
    # from the JAX package's checkpoints; and the loaded weights are the
    # writer's (bit-equal, folded leaves within their bounds)
    root = released["root"]
    if not (root / "port_dir").exists():
        _convert(conv.main, released["dir"], root / "port_dir")
        _convert(jconv.main, released["dir"], root / "jax_dir")
    port_dirs = dict(a2m_ckpt_dir=str(root / "port_dir" / "audio2secc"),
                     secc2video_ckpt_dir=str(root / "port_dir" / "secc2video"))
    jax_dirs = dict(a2m_ckpt_dir=str(root / "jax_dir" / "audio2secc"),
                    secc2video_ckpt_dir=str(root / "jax_dir" / "secc2video"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _zeros_init())
        jp = jpipe.Real3DPortraitPipeline(jax_load_config(ORIG, TINY), mock_weights=False,
                                          seed=0, **jax_dirs)
    pipe = pipe_mod.Real3DPortraitPipeline(port_config.load_config(ORIG, TINY), seed=1,
                                           device="cpu", mock_weights=False, **port_dirs)
    writer = released["pipe"]
    for mod, got, ref in ((writer.model, pipe.model, released["s2v"]),
                          (writer.a2m, pipe.a2m, released["a2m"])):
        ref_layout.check_converted(mod, ref, got.state_dict())
    wav = chirp_wav(0.32, seed=8)
    src = np.random.RandomState(9).randint(0, 256, (64, 64, 3)).astype(np.uint8)
    want = jp.run(src, wav=wav, temperature=0.0)
    got = pipe.run(src, wav=wav, temperature=0.0)
    assert got.shape == (8, 64, 64, 3)
    agree(got, want, 3e-2, 3e-3, "run frames from converted checkpoints")


def test_port_command_line_runs_without_jax_or_flax(released):
    # (e): jax, flax, the JAX package and the root tools unimportable; the
    # files are the in-process port command line's
    out = released["root"] / "no_jax"
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'ml_dtypes',\n"
        "          'real3dportrait_tpu', 'tools'):\n"
        "    sys.modules[m] = None\n"
        "from real3dportrait_tpu_torch.tools.convert_torch_ckpt import main\n"
        f"main(['--audio2secc', {released['dir'][0]!r}, '--secc2video',\n"
        f"      {released['dir'][1]!r}, '--out', {str(out)!r}])\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None and\n"
        "             m.split('.')[0] in ('jax', 'flax', 'msgpack', 'ml_dtypes', 'tools'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "| secc2video:" in proc.stdout
    if not (released["root"] / "port_dir").exists():
        _convert(conv.main, released["dir"], released["root"] / "port_dir")
    assert _files(out) == _files(released["root"] / "port_dir")


# -- fit_to_template -----------------------------------------------------------------


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def test_fit_to_template_strict_and_lenient_as_jax(capsys):
    # (f): a clean tree fits strictly and casts to the template's dtypes;
    # a tree with a missing, a misshaped and an extra leaf raises, naming
    # each, in strict mode and keeps init leaves in lenient mode, printing
    # the JAX lines; extra leaves alone never fail a lenient fit
    module = _seeded(MappingNetwork(12, 24, num_layers=3, z_dim=16, num_ws=5), 10)
    template = jax_variables_from_torch(_seeded(copy.deepcopy(module), 21))
    jtemplate = jax.tree.map(jnp.asarray, template)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float64),
                        conv.convert_mapping_network(ref_layout.stylegan(module).state_dict))
    got, want = conv.fit_to_template(tree, template), jconv.fit_to_template(tree, jtemplate)
    assert all(type(v) is np.ndarray and v.dtype == np.float32 for v in _flat(got).values())
    assert_same_tree(got, jax.tree.map(np.asarray, want))

    broken = copy.deepcopy(tree)
    del broken["params"]["fc0"]["bias"]
    broken["params"]["fc1"]["weight"] = np.zeros((3, 3))
    broken["params"]["fc9"] = {"bias": np.zeros(2)}
    with pytest.raises(ValueError) as port_err:
        conv.fit_to_template(broken, template)
    with pytest.raises(ValueError) as jax_err:
        jconv.fit_to_template(broken, jtemplate)
    assert str(port_err.value) == str(jax_err.value)
    for name in ("missing   params.fc0.bias", "shape     params.fc1.weight",
                 "extra     params.fc9.bias"):
        assert name in str(port_err.value)
    capsys.readouterr()
    got = conv.fit_to_template(broken, template, strict=False)
    port_lines = capsys.readouterr().out
    want = jconv.fit_to_template(broken, jtemplate, strict=False)
    assert port_lines == capsys.readouterr().out
    assert port_lines.startswith("| fit_to_template: 2 leaves kept from init:")
    assert_same_tree(got, jax.tree.map(np.asarray, want))
    flat, init = _flat(got), _flat(template)
    for k in ("/params/fc0/bias", "/params/fc1/weight"):
        np.testing.assert_array_equal(flat[k], init[k])
    extra_only = copy.deepcopy(tree)
    extra_only["params"]["fc9"] = {"bias": np.zeros(2)}
    conv.fit_to_template(extra_only, template, strict=False)
    assert capsys.readouterr().out == ""
    with pytest.raises(ValueError, match="extra     params.fc9.bias"):
        conv.fit_to_template(extra_only, template)


# -- the parity tool -------------------------------------------------------------------


def test_parity_tool_converts_torch_checkpoints_as_its_directories(released):
    # --torch_a2m / --torch_s2v convert into <out>/converted; the report
    # and frames equal those rendered from those directories
    hparams = ",".join(f"{k}={v}" for k, v in TINY.items())
    tmp_path = released["root"] / "parity"
    fixtures = str(tmp_path / "fixtures")
    eval_parity.make_selftest_fixtures(released["pipe"], fixtures, t=2)
    common = ["--fixtures", fixtures, "--device", "cpu", "--hparams", hparams,
              "--no_preset_delta"]
    a, b = tmp_path / "a", tmp_path / "b"
    rc_a = eval_parity.main(["--torch_a2m", released["file"][0], "--torch_s2v",
                             released["file"][1], "--out", str(a)] + common)
    converted = a / "converted"
    assert sorted(_files(converted)) == ["audio2secc/model_ckpt_steps_120.ckpt",
                                         "secc2video/model_ckpt_steps_340.ckpt"]
    rc_b = eval_parity.main(["--a2m_ckpt", str(converted / "audio2secc"), "--s2v_ckpt",
                             str(converted / "secc2video"), "--out", str(b)] + common)
    reports = []
    for d in (a, b):
        with open(d / "parity_report.json") as f:
            reports.append(json.load(f))
    assert rc_a == rc_b and reports[0] == reports[1]
    np.testing.assert_array_equal(np.load(a / "rendered_frames.npy"),
                                  np.load(b / "rendered_frames.npy"))
