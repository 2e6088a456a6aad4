"""The port's audio front end and audio-to-motion model against the JAX
package on the CPU: the log-mel and pitch copies (bit-equal), the pitch
bins, tiny HuBERT encoders of both families and their extractor, and the
full-width ``PitchContourVAEModel`` (``gn`` and ``folded_bn``) and
``VAEModel`` at ``temperature=0`` and with a given prior noise. Weights are
seeded numpy leaves on each JAX module's init tree, loaded with
``torch_state_dict_from_jax`` and strict name matching."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real3dportrait_tpu.audio import features as jfeat
from real3dportrait_tpu.audio import hubert as jhub
from real3dportrait_tpu.models import audio2motion as ja2m
from real3dportrait_tpu_torch.audio import features
from real3dportrait_tpu_torch.audio import hubert
from real3dportrait_tpu_torch.models import audio2motion
from real3dportrait_tpu_torch.weights import mock_init_, torch_state_dict_from_jax
from tests._torch_parity import agree, jax_run, load_from_jax, t

torch.set_num_threads(1)


def chirp_wav(seconds: float, seed: int = 0) -> np.ndarray:
    """A 120-220 Hz chirp plus noise at 16 kHz, float32 in [-1, 1]."""
    rng = np.random.RandomState(seed)
    n = int(16000 * seconds)
    tt = np.arange(n) / 16000.0
    f = 120.0 + 100.0 * tt / max(seconds, 1e-6)
    wav = 0.5 * np.sin(2 * np.pi * np.cumsum(f) / 16000.0) + 0.05 * rng.randn(n)
    return np.clip(wav, -1, 1).astype(np.float32)


def test_mel_and_f0_are_bit_equal_to_jax():
    wav = chirp_wav(0.7)
    mel = features.extract_mel(wav)
    f0 = features.extract_f0(wav)
    assert mel.shape == (36, 80) and f0.shape == (36,)
    np.testing.assert_array_equal(mel, jfeat.extract_mel(wav))
    np.testing.assert_array_equal(f0, jfeat.extract_f0(wav))
    assert 100 < float(np.median(f0[f0 > 0])) < 260  # the chirp's pitch is found
    short = wav[:700]                                 # under one analysis frame
    np.testing.assert_array_equal(features.extract_f0(short), jfeat.extract_f0(short))


def test_f0_to_coarse_matches_jax():
    # exact bins, including 0 (unvoiced), both clip ends and a dense sweep
    f0 = np.concatenate([[0.0, 1.0, 49.0, 50.0, 1100.0, 5000.0],
                         np.linspace(40, 1200, 4001)]).astype(np.float32)
    np.testing.assert_array_equal(audio2motion.f0_to_coarse(t(f0)).numpy(),
                                  np.asarray(ja2m.f0_to_coarse(jnp.asarray(f0))))


TINY_HUBERT = dict(hidden=32, layers=2, heads=4, ffn=64, conv_dims=(16,) * 7,
                   pos_conv_kernel=8, pos_conv_groups=4)


@pytest.mark.parametrize("family", ["layer", "group"])
def test_tiny_hubert_matches_jax(family):
    # 7 convs + 2 transformer layers in fp32: 1e-5 of scale max, 1e-6 mean
    kw = dict(TINY_HUBERT)
    if family == "group":
        kw.update(feat_extract_norm="group", do_stable_layer_norm=False,
                  feat_proj_layer_norm=False)
    wav = np.random.RandomState(1).randn(1, 4000).astype(np.float32)
    variables, want = jax_run(jhub.HubertEncoder(**kw), wav, seed=2)
    tm = load_from_jax(hubert.HubertEncoder(**kw), variables)
    with torch.no_grad():
        got = tm(t(wav))
    assert got.shape == (1, 12, 32)
    agree(got, want, 1e-5, 1e-6, f"hubert {family}")


def test_hubert_extractor_matches_jax():
    # per-utterance normalisation and the chunking around one 2-layer model
    wav = chirp_wav(0.4, seed=3)
    module = jhub.HubertEncoder(**TINY_HUBERT)
    variables, _ = jax_run(module, wav[None, :4000], seed=4)
    want = jhub.make_jax_hubert_extractor(variables, module)(wav)
    tm = load_from_jax(hubert.HubertEncoder(**TINY_HUBERT), variables)
    got = hubert.make_hubert_extractor(tm)(wav)
    agree(got, want, 1e-5, 1e-6, "hubert extractor")


def test_hubert_large_builds_with_the_released_shapes():
    n = sum(p.numel() for p in hubert.hubert_large().parameters())
    assert 3.1e8 < n < 3.2e8  # hubert-large: ~316M parameters
    assert hubert.hubert_base().n_layers == 12


def _a2m_batch(t50: int, audio_dim: int, seed: int = 5) -> dict:
    rng = np.random.RandomState(seed)
    return {"audio": rng.randn(1, t50, audio_dim).astype(np.float32),
            "f0": rng.uniform(80, 400, (1, t50)).astype(np.float32)
            * (rng.rand(1, t50) > 0.2),
            "y_mask": np.ones((1, t50 // 2), np.float32),
            "blink": rng.randint(0, 2, (1, t50, 1)).astype(np.int32),
            "mouth_amp": np.full((1, 1), 0.45, np.float32)}


def _jax_a2m(module, batch, temperature, monkeypatch=None, z=None):
    """Seeded variables on the model's training tree (the encoder too) and
    its inference apply; ``z`` replaces the prior's normal draw."""
    init_batch = dict(batch, y=np.zeros((1, batch["audio"].shape[1] // 2, 64), np.float32))
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jax.tree.map(jnp.asarray, init_batch), train=True))
    from tests._torch_parity import random_like

    variables = random_like(shapes, seed=6)
    if z is not None:
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape, *a, **k: jnp.asarray(z).reshape(shape))
    out = module.apply(variables, jax.tree.map(jnp.asarray, batch), train=False,
                       temperature=temperature, rngs={"noise": jax.random.PRNGKey(7)})
    return variables, out


@pytest.mark.parametrize("cls,norm_mode,temperature", [
    ("PitchContourVAEModel", "gn", 0.0), ("PitchContourVAEModel", "gn", 0.7),
    ("PitchContourVAEModel", "folded_bn", 0.0), ("PitchContourVAEModel", "folded_bn", 0.7),
    ("VAEModel", "gn", 0.0), ("VAEModel", "gn", 0.7)],
    ids=["pitch_gn_t0", "pitch_gn_z", "pitch_folded_bn_t0", "pitch_folded_bn_z", "vae_t0",
         "vae_z"])
def test_audio_to_motion_matches_jax(monkeypatch, cls, norm_mode, temperature):
    # full width (1024-d audio, 256-wide VAE, 4-flow prior) at T = 32: about
    # 40 conv layers in fp32, 1e-5 of scale max, 1e-6 mean. At temperature
    # 0 the noise is irrelevant; otherwise both take the same z.
    batch = _a2m_batch(32, 1024)
    z = np.random.RandomState(8).randn(1, 4, 16).astype(np.float32)
    jm = getattr(ja2m, cls)(norm_mode=norm_mode)
    variables, want = _jax_a2m(jm, batch, temperature, monkeypatch,
                               z if temperature else None)
    tm = load_from_jax(getattr(audio2motion, cls)(norm_mode=norm_mode), variables)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = tm(tb, temperature=temperature, z=t(z) if temperature else None,
                 generator=torch.Generator().manual_seed(0))
    assert got["pred"].shape == (1, 16, 64)
    agree(got["pred"], want["pred"], 1e-5, 1e-6, f"{cls} pred")
    agree(got["z_p"], want["z_p"], 1e-5, 1e-6, f"{cls} z_p")


def test_audio_to_motion_weight_bridge_is_strict_and_mock_init_draws_every_weight():
    jm = ja2m.PitchContourVAEModel()
    batch = dict(_a2m_batch(32, 1024), y=np.zeros((1, 16, 64), np.float32))
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jax.tree.map(jnp.asarray, batch), train=True))
    tm = audio2motion.PitchContourVAEModel()
    converted = torch_state_dict_from_jax(shapes)
    assert set(converted) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert tuple(converted[k].shape) == tuple(v.shape), k
    mock_init_(tm, torch.Generator().manual_seed(0))
    assert float(tm.mouth_amp_embed.std()) > 0.5            # N(0, 1)
    assert float(tm.vae.prior_flow.flow_0.post.weight.abs().max()) == 0.0
    assert 0.05 < float(tm.pitch_embed.weight.std()) < 0.13  # N(0, 1/128)
