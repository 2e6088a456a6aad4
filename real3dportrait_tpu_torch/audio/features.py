"""Audio front end on the host: log-mel spectrogram and pitch (port of
``real3dportrait_tpu/audio/features.py``, ``extract_mel`` and the pYIN
tracker ``extract_f0_pyin``), and its utilities: MFCCs, an energy voice
activity detector and Griffin-Lim reconstruction.

Numpy on the host, as in the JAX package, and kept as the port's own copy:
16 kHz audio, hop 320 (50 frames/s), 80 mel bins; F0 at the same 50 frames/s
(0 = unvoiced). The same wav gives the same arrays, bit for bit, in both
packages.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000
HOP = 320          # 20 ms -> 50 fps
N_FFT = 512
N_MELS = 80
F_MIN, F_MAX = 55.0, 7600.0


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def _mel_filterbank(sr=SAMPLE_RATE, n_fft=N_FFT, n_mels=N_MELS,
                    fmin=F_MIN, fmax=F_MAX) -> np.ndarray:
    """Slaney-style triangular filterbank [n_mels, n_fft//2+1]."""
    mels = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    freqs = _mel_to_hz(mels)
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    fb = np.zeros((n_mels, len(fft_freqs)), np.float32)
    for i in range(n_mels):
        lo, ctr, hi = freqs[i], freqs[i + 1], freqs[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    enorm = 2.0 / (freqs[2:] - freqs[:-2])
    return fb * enorm[:, None]


def extract_mel(wav: np.ndarray, sr: int = SAMPLE_RATE) -> np.ndarray:
    """wav [N] float in [-1,1] -> log-mel [T, 80] at 50 fps."""
    assert sr == SAMPLE_RATE, "resample to 16 kHz first"
    wav = np.asarray(wav, np.float32)
    pad = N_FFT // 2
    wav = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (len(wav) - N_FFT) // HOP
    window = np.hanning(N_FFT).astype(np.float32)
    idx = np.arange(N_FFT)[None, :] + HOP * np.arange(n_frames)[:, None]
    frames = wav[idx] * window
    spec = np.abs(np.fft.rfft(frames, n=N_FFT, axis=-1))
    mel = spec @ _mel_filterbank().T
    return np.log10(np.maximum(mel, 1e-5)).astype(np.float32)


def extract_f0(wav: np.ndarray, sr: int = SAMPLE_RATE,
               fmin: float = 60.0, fmax: float = 500.0) -> np.ndarray:
    """wav [N] -> F0 [T] in Hz at 50 fps (0 = unvoiced).

    pYIN-style tracker replacing the reference's parselmouth call
    (`utils/audio/pitch_extractors.py:75`): cumulative mean-normalized
    difference function (YIN), multi-candidate extraction, and Viterbi
    smoothing over log-pitch bins with a voiced/unvoiced state — the
    temporal model is what suppresses octave errors, which the plain
    per-frame autocorrelation stand-in had no defense against.
    """
    return extract_f0_pyin(wav, sr=sr, fmin=fmin, fmax=fmax)


def extract_f0_pyin(wav: np.ndarray, sr: int = SAMPLE_RATE,
                    fmin: float = 60.0, fmax: float = 500.0,
                    n_bins: int = 96, voiced_threshold: float = 0.45,
                    switch_penalty: float = 6.0,
                    transition_semitones: float = 1.5) -> np.ndarray:
    """pYIN-style F0: YIN CMNDF candidates + Viterbi over log-pitch bins.

    Vectorized numpy; frames are 40 ms at the 50 fps HOP, matching the mel
    frame convention (center-aligned, like :func:`extract_mel`).
    """
    wav = np.asarray(wav, np.float32)
    frame_len = 4 * HOP  # 40 ms window at 16 kHz (HOP=320)
    n_mel_frames = 1 + len(wav) // HOP
    if len(wav) < frame_len:
        return np.zeros((n_mel_frames,), np.float32)
    # center alignment: pad so frame t is centered at t*HOP
    pad = frame_len // 2
    w = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = min(n_mel_frames, 1 + (len(w) - frame_len) // HOP)
    idx = np.arange(frame_len)[None, :] + HOP * np.arange(n_frames)[:, None]
    frames = w[idx]  # [T, L]
    frames = frames - frames.mean(axis=1, keepdims=True)

    lag_min = max(2, int(sr / fmax))
    lag_max = min(frame_len // 2, int(np.ceil(sr / fmin)))

    # --- YIN difference function via FFT autocorrelation -------------------
    # d[t, tau] = sum_j (x_j - x_{j+tau})^2 over j in [0, L-tau)
    L = frame_len
    nfft = 1 << int(np.ceil(np.log2(2 * L)))
    spec = np.fft.rfft(frames, n=nfft, axis=1)
    ac = np.fft.irfft(spec * np.conj(spec), n=nfft, axis=1)[:, :lag_max + 1]
    sq = frames ** 2
    csum = np.concatenate([np.zeros((n_frames, 1), np.float32),
                           np.cumsum(sq, axis=1)], axis=1)  # [T, L+1]
    taus = np.arange(lag_max + 1)
    # energy of x[0:L-tau] and x[tau:L]
    e_head = csum[:, L - taus] - csum[:, 0:1]          # [T, lag_max+1]
    e_tail = csum[:, L:L + 1] - csum[:, taus]
    d = e_head + e_tail - 2.0 * ac                      # [T, lag_max+1]
    d = np.maximum(d, 0.0)

    # cumulative mean normalization: d'[0]=1, d'[tau]=d[tau]*tau/cumsum(d)
    dcum = np.cumsum(d[:, 1:], axis=1)
    cmndf = np.ones_like(d)
    cmndf[:, 1:] = d[:, 1:] * taus[1:][None, :] / np.maximum(dcum, 1e-12)

    # --- candidates: local minima of the CMNDF in the lag range ------------
    seg = cmndf[:, lag_min:lag_max]                     # [T, R]
    left = cmndf[:, lag_min - 1:lag_max - 1]
    right = cmndf[:, lag_min + 1:lag_max + 1]
    is_min = (seg <= left) & (seg < right)
    # voicing strength per frame from the best minimum
    best = np.min(np.where(is_min, seg, np.inf), axis=1)
    best = np.where(np.isfinite(best), best, 1.0)
    voiced_prob = np.clip(1.0 - best, 0.0, 1.0)

    # parabolic lag refinement for every lag position (vectorized)
    denom = left - 2 * seg + right
    safe = np.where(np.abs(denom) > 1e-12, denom, 1.0)
    shift = np.where(np.abs(denom) > 1e-12, 0.5 * (left - right) / safe, 0.0)
    shift = np.clip(shift, -0.5, 0.5)
    lags = taus[lag_min:lag_max][None, :] + shift       # [T, R]
    cand_freq = sr / np.maximum(lags, 1e-6)

    # --- observation matrix over log-pitch bins ----------------------------
    log_fmin, log_fmax = np.log(fmin), np.log(fmax)
    bin_centers = np.exp(np.linspace(log_fmin, log_fmax, n_bins))
    bin_width = (log_fmax - log_fmin) / (n_bins - 1)
    # candidate weight: YIN threshold family — candidates with lower CMNDF
    # get more mass; deeper minima beat shallower ones at octave multiples
    cand_w = np.where(is_min, np.clip(1.0 - seg, 0.0, 1.0) ** 2, 0.0)
    # bin of each candidate
    cand_bin = np.clip(((np.log(cand_freq) - log_fmin) / bin_width + 0.5)
                       .astype(np.int32), 0, n_bins - 1)
    obs = np.zeros((n_frames, n_bins), np.float32)
    tidx = np.repeat(np.arange(n_frames), cand_bin.shape[1])
    np.add.at(obs, (tidx, cand_bin.ravel()), cand_w.ravel())
    obs_v = obs * voiced_prob[:, None]
    obs_uv = np.maximum(1.0 - voiced_prob, 1e-4)

    # --- Viterbi over [n_bins voiced] + [1 unvoiced] state -----------------
    sigma_bins = transition_semitones / 12.0 * np.log(2.0) / bin_width
    db = np.arange(n_bins)[:, None] - np.arange(n_bins)[None, :]
    logT = -0.5 * (db / max(sigma_bins, 1e-6)) ** 2     # [B, B]
    log_obs_v = np.log(np.maximum(obs_v, 1e-8))
    log_obs_uv = np.log(obs_uv)

    NEG = -1e9
    delta = np.full((n_bins + 1,), NEG, np.float32)
    delta[:n_bins] = log_obs_v[0]
    delta[n_bins] = log_obs_uv[0]
    psi = np.zeros((n_frames, n_bins + 1), np.int32)
    for t in range(1, n_frames):
        # voiced bins: from voiced (pitch-continuity) or from unvoiced
        scores_vv = delta[None, :n_bins] + logT          # [B, B]
        best_vv = np.argmax(scores_vv, axis=1)
        val_vv = scores_vv[np.arange(n_bins), best_vv]
        val_uv_v = delta[n_bins] - switch_penalty        # re-entry
        use_uv = val_uv_v > val_vv
        new_v = np.where(use_uv, val_uv_v, val_vv) + log_obs_v[t]
        psi[t, :n_bins] = np.where(use_uv, n_bins, best_vv)
        # unvoiced state: from best voiced (switch penalty) or stay
        best_v = int(np.argmax(delta[:n_bins]))
        stay = delta[n_bins]
        leave = delta[best_v] - switch_penalty
        if leave > stay:
            psi[t, n_bins] = best_v
            new_uv = leave + log_obs_uv[t]
        else:
            psi[t, n_bins] = n_bins
            new_uv = stay + log_obs_uv[t]
        delta = np.concatenate([new_v, [new_uv]]).astype(np.float32)

    # backtrack
    state = int(np.argmax(delta))
    path = np.zeros((n_frames,), np.int32)
    for t in range(n_frames - 1, -1, -1):
        path[t] = state
        state = int(psi[t, state])

    # --- read out: refine within the chosen bin ----------------------------
    f0 = np.zeros((n_frames,), np.float32)
    for t in range(n_frames):
        b = path[t]
        if b >= n_bins:
            continue
        # best candidate whose bin is within 1 of the Viterbi bin
        ok = is_min[t] & (np.abs(cand_bin[t] - b) <= 1)
        if not ok.any():
            f0[t] = bin_centers[b]
            continue
        ci = int(np.argmax(np.where(ok, cand_w[t], -1.0)))
        f0[t] = cand_freq[t, ci]

    if len(f0) < n_mel_frames:
        f0 = np.pad(f0, (0, n_mel_frames - len(f0)), mode="edge")
    return f0[:n_mel_frames].astype(np.float32)


def extract_mfcc(wav: np.ndarray, n_mfcc: int = 13, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Log-mel -> DCT-II cepstral coefficients [T, n_mfcc]."""
    logmel = extract_mel(wav, sr)
    t, n = logmel.shape
    k = np.arange(n_mfcc)[:, None]
    basis = np.cos(np.pi * k * (2 * np.arange(n)[None] + 1) / (2 * n))
    basis *= np.sqrt(2.0 / n)
    basis[0] *= np.sqrt(0.5)
    return (logmel @ basis.T).astype(np.float32)


def vad(wav: np.ndarray, sr: int = SAMPLE_RATE, threshold_db: float = -40.0) -> np.ndarray:
    """Energy voice activity [T] bool at 50 frames/s: a frame's RMS above
    ``threshold_db``."""
    n_frames = max(1 + (len(wav) - N_FFT) // HOP, 0)
    idx = np.arange(N_FFT)[None, :] + HOP * np.arange(n_frames)[:, None]
    frames = np.asarray(wav, np.float32)[idx]
    rms = np.sqrt(np.mean(frames**2, axis=-1) + 1e-12)
    db = 20 * np.log10(rms + 1e-12)
    return db > threshold_db


def griffin_lim(mag: np.ndarray, n_iters: int = 30, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Linear-magnitude spectrogram [T, n_fft//2+1] -> waveform, by
    Griffin-Lim from seeded random phases (a reconstruction utility)."""
    rng = np.random.RandomState(0)
    angles = np.exp(2j * np.pi * rng.rand(*mag.shape))
    window = np.hanning(N_FFT).astype(np.float32)

    def istft(spec):
        frames = np.fft.irfft(spec, n=N_FFT, axis=-1) * window
        out = np.zeros((len(spec) - 1) * HOP + N_FFT, np.float32)
        wsum = np.zeros_like(out)
        for i, fr in enumerate(frames):
            out[i * HOP: i * HOP + N_FFT] += fr
            wsum[i * HOP: i * HOP + N_FFT] += window**2
        return out / np.maximum(wsum, 1e-8)

    def stft(wav):
        n_frames = 1 + (len(wav) - N_FFT) // HOP
        idx = np.arange(N_FFT)[None, :] + HOP * np.arange(n_frames)[:, None]
        return np.fft.rfft(wav[idx] * window, n=N_FFT, axis=-1)

    wav = istft(mag * angles)
    for _ in range(n_iters):
        spec = stft(wav)
        angles = np.exp(1j * np.angle(spec[: len(mag)]))
        wav = istft(mag * angles)
    return wav.astype(np.float32)
