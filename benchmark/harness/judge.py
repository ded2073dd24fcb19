"""The comparison that decides ``correct``: the system's answers against
the plain reference, request by request, at the shapes the system ran.

For each sampled answer the reference
1. maps the request's text to ids with its own frontend, and counts a
   mismatch with the ids the system was given (``ids_mismatch``);
2. runs its encoder in float32 (TF32 off) and reads the system's
   durations as a served model's tokens are read: a duration is a ceil of
   the predicted w, times the speaking rate, and where the system's
   differs from the reference's the gap is how far the reference's w lies
   outside the interval that would give the system's (``dur_gap``, in
   frames of w; 0 where they agree). Rounding in a lower precision moves
   w by a little and can flip a ceil that lies close to an integer;
3. runs its decoder over the system's durations, from the same unit
   noise (the reference draws it again from the same generator seed and
   shape), at the mel bucket the system used, then its vocoder (the
   configuration's ``vocoder_arch``) at the system's vocoder bucket, the
   clip, and the denoiser where the architecture has a bias;
4. compares: the answer's length with the durations' (``len_mismatch``),
   the relative L2 error of the mel over the answer's frames
   (``mel_err``), and that of the waveform in units of the vocoder's own
   response to a relative mel noise of ``WAV_EPS`` (``wav_err``).
The control is the same reference in bfloat16 (the encoder's products
under autocast, the decoder and the vocoder with bf16 weights and
activations; the denoiser stays float32), put in the system's place on
the same prompts and the same alignment: the gap of the durations it would choose
and its mel and waveform errors against the float32 reference are
``*_control``.
"""

import numpy as np
import torch

HOP = 256
#: the relative size of the mel noise whose effect on the waveform is the
#: unit of ``wav_err``
WAV_EPS = 1e-3


class _NoTF32:
    """cuDNN and matmul TF32 off inside, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved
        return False


def reference_ids(text: str, cleaner: str) -> np.ndarray:
    from benchmark.reference.text import intersperse, text_to_sequence
    return np.asarray(intersperse(text_to_sequence(text, [cleaner]), 0), np.int64)


def read_durations(w: np.ndarray, frames: np.ndarray, length_scale: float, n: int,
                   tol: float = 1e-3):
    """The system's integer durations k (w_ceil = k * length_scale) that
    give its frames per id (``frames``, the rows of its alignment, cut at
    the ``n`` valid frames), read id by id nearest the reference's own
    ceil(w), and the gap: how far the reference's w lies outside the
    interval (k - 1, k] of each, the most over the ids (0 where every k is
    the reference's own ceil). ``inf`` where no k gives the system's
    frames."""
    edges = np.cumsum(np.asarray(frames, np.float64))
    k_ref = np.ceil(w)
    ks, cum, gap = [], 0.0, 0.0
    for i in range(len(w)):
        found = None
        for dk in (0, -1, 1, -2, 2, -3, 3):
            k = k_ref[i] + dk
            if k < 0:
                continue
            v = cum + k * length_scale
            if (edges[i] - 1 - tol < v <= edges[i] + tol
                    or (edges[i] >= n and v > n - 1 - tol)):
                found = k
                break
        if found is None:
            return None, float("inf")
        ks.append(found)
        cum += found * length_scale
        gap = max(gap, w[i] - found, (found - 1) - w[i], 0.0)
    return np.asarray(ks), float(gap)


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


class Reference:
    """The reference's models on ``device``, and the per-answer check."""

    def __init__(self, cfg: dict, seed: int, device, control: bool = False):
        from benchmark.harness.models import reference_models
        from benchmark.reference.models.matcha import decoder_cast

        syn = cfg["synthesis"]
        self.cfg, self.device = cfg, device
        self.cleaner = cfg["cleaner"]
        self.n_timesteps, self.temperature = syn["n_timesteps"], syn["temperature"]
        self.length_scale, self.strength = syn["length_scale"], syn["denoiser_strength"]
        with _NoTF32():
            self.model, self.vocoder, self.bias = reference_models(cfg, seed, device)
        self.control = control
        if control:
            import copy
            self.model_bf16 = decoder_cast(self.model, torch.bfloat16)
            self.vocoder_bf16 = copy.deepcopy(self.vocoder).to(torch.bfloat16).eval()
        # the vocoder's own response to a relative mel noise of WAV_EPS:
        # the unit of ``wav_err``
        self._probe = torch.Generator(device).manual_seed(20250917)

    @torch.inference_mode()
    def _finish(self, mel_btc: torch.Tensor, vocoder, T_voc: int, n: int) -> np.ndarray:
        from benchmark.reference.models.denoiser import denoise
        mel = mel_btc[:, :T_voc].to(next(vocoder.parameters()).dtype)
        wav = torch.clamp(vocoder(mel).float()[..., 0], -1.0, 1.0)
        if self.bias is not None:
            wav = denoise(wav, self.bias, strength=self.strength)
        return wav[0, :n * HOP].cpu().numpy()

    def _decode(self, model, mu_x, frames, n: int, T_y: int, noise, spks, dtype):
        """The reference's decode over the system's alignment (``frames``
        per id, in order), the first ``n`` frames of a ``T_y`` bucket
        valid, from the unit noise (T_y, n_feats): the mel (1, n_feats,
        T_y) in f32. ``dtype`` bf16 runs the Euler loop in bf16 (the
        control)."""
        from benchmark.reference.ops.seq import denormalize, sequence_mask
        dev = self.device
        edges = np.concatenate([[0], np.cumsum(frames)]).astype(np.int64)
        attn = torch.zeros((1, len(frames), T_y), device=dev)
        for i in range(len(frames)):
            attn[0, i, min(edges[i], T_y):min(edges[i + 1], T_y)] = 1.0
        y_mask = sequence_mask(torch.tensor([n], device=dev), T_y).float()[..., None]
        attn = attn * y_mask[:, :, 0][:, None, :]
        mu_y = torch.einsum("bxy,bxf->byf", attn, mu_x)
        spk_emb = model._speaker(spks)
        z = noise[None].to(dev)
        if dtype is None:
            out = model.decoder(mu_y, y_mask, self.n_timesteps, self.temperature, z, None, spk_emb)
        else:
            out = model.decoder(mu_y.to(dtype), y_mask.to(dtype), self.n_timesteps,
                                self.temperature, z, None,
                                None if spk_emb is None else spk_emb.to(dtype)).float()
        return denormalize(out.transpose(1, 2), model.mel_mean, model.mel_std)

    def _wav_err(self, wav, wav_ref, mel_ref, T_voc: int, n: int) -> float:
        """The waveform's relative L2 error in units of the reference
        vocoder's own response to a relative mel noise of ``WAV_EPS``: the
        relative mel error that would move the waveform as far. Random
        weights amplify a mel error into the waveform by an amount that
        changes with the seed; this unit takes that out."""
        g = torch.randn(mel_ref.shape, generator=self._probe, device=self.device)
        m = mel_ref[:, :, :n]
        scale = WAV_EPS * torch.sqrt(torch.mean(m * m))
        pert = self._finish((mel_ref + scale * g).transpose(1, 2), self.vocoder, T_voc, n)
        return _rel(wav, wav_ref) * WAV_EPS / max(_rel(pert, wav_ref), 1e-30)

    @torch.inference_mode()
    def check(self, row: dict) -> dict:
        """One answer. ``row``: ``text``, ``spk`` (or None), ``ids`` (what
        the system was given), ``durations`` (its per-id durations),
        ``T_y``, ``T_voc``, ``noise`` ((T_y, n_feats) unit noise on the
        device), ``n`` (the answer's frames), ``wav`` (the answer, n *
        hop samples) and ``mel`` ((n_feats, n) or None)."""
        out = {"ids_mismatch": 0, "len_mismatch": 0}
        ids = reference_ids(row["text"], self.cleaner)
        if not np.array_equal(ids, np.asarray(row["ids"], np.int64)):
            out["ids_mismatch"] = 1
        dev = self.device
        with _NoTF32():
            x = torch.as_tensor(ids, device=dev)[None]
            xl = torch.tensor([len(ids)], device=dev)
            spks = None if row["spk"] is None else torch.tensor([row["spk"]], device=dev)
            spk_emb = self.model._speaker(spks)
            from benchmark.reference.ops.seq import sequence_mask
            x_mask = sequence_mask(xl, x.shape[1]).float()[..., None]
            mu_x, logw = self.model.encoder(x, x_mask, spk_emb)
            w = (torch.exp(torch.clamp(logw, max=11.0)) * x_mask)[0, :, 0].double().cpu().numpy()
            frames = np.rint(np.asarray(row["durations"], np.float64)[:len(ids)])
            if frames.shape != w.shape:
                return dict(out, ids_mismatch=1, dur_gap=float("inf"), wav_err=float("inf"),
                            mel_err=float("inf"))
            n = row["n"]
            ks, out["dur_gap"] = read_durations(w, frames, self.length_scale, n)
            total = float(np.sum(ks) * self.length_scale) if ks is not None else -1.0
            # y_length is the f32 sum of the durations, truncated: allow the
            # rounding of a sum that lands on an integer
            ok_len = ks is not None and (min(int(np.floor(total + 1e-3)), row["T_y"]) == n
                                         or min(int(np.floor(total - 1e-3)), row["T_y"]) == n)
            if not ok_len or len(row["wav"]) != n * HOP:
                out["len_mismatch"] = 1
                out.update(wav_err=float("inf"), mel_err=float("inf"))
                return out
            dec = self._decode(self.model, mu_x, frames, n, row["T_y"], row["noise"], spks, None)
            mel_ref = dec  # (1, n_feats, T_y)
            wav_ref = self._finish(mel_ref.transpose(1, 2), self.vocoder, row["T_voc"], n)
            out["wav_err"] = self._wav_err(np.asarray(row["wav"], np.float64), wav_ref, mel_ref,
                                           row["T_voc"], n)
            mel_ref_np = mel_ref[0, :, :n].double().cpu().numpy()
            out["mel_err"] = (None if row.get("mel") is None
                              else _rel(np.asarray(row["mel"], np.float64), mel_ref_np))
            if self.control:
                # the reference in bf16 in the system's place, on the same
                # prompts and alignment: the gap of the durations it would
                # choose, and its mel and waveform
                mb = self.model_bf16
                with torch.autocast(dev.type, dtype=torch.bfloat16):
                    mu_c, logw_c = self.model.encoder(x, x_mask, spk_emb)
                mu_c, logw_c = mu_c.float(), logw_c.float()
                w_c = torch.exp(torch.clamp(logw_c, max=11.0))[0, :, 0]
                k_c = torch.ceil(w_c).double().cpu().numpy()
                out["dur_gap_control"] = float(np.max(np.maximum(
                    np.maximum(w - k_c, (k_c - 1) - w), 0.0), initial=0.0))
                mel_c = self._decode(mb, mu_c, frames, n, row["T_y"], row["noise"], spks,
                                     torch.bfloat16)
                wav_c = self._finish(mel_c.transpose(1, 2), self.vocoder_bf16, row["T_voc"], n)
                out["wav_err_control"] = self._wav_err(wav_c, wav_ref, mel_ref, row["T_voc"], n)
                out["mel_err_control"] = _rel(mel_c[0, :, :n].double().cpu().numpy(), mel_ref_np)
        return out


def summarise(results: list, limits: dict, answered: int, due: int) -> tuple:
    """(correct, checks): each compared number, the worst over the sampled
    answers, beside its limit; plus the answers that never came."""
    def worst(key):
        vals = [r[key] for r in results if r.get(key) is not None]
        return max(vals) if vals else None

    checks = [{"name": "unanswered", "value": due - answered, "limit": 0, "rule": "equal"},
              {"name": "checked", "value": len(results), "limit": limits["min_checked"],
               "rule": "at least"}]
    for key in ("ids_mismatch", "len_mismatch"):
        checks.append({"name": key, "value": sum(r[key] for r in results), "limit": 0,
                       "rule": "equal"})
    for key in ("dur_gap", "wav_err", "mel_err"):
        if key in limits:
            checks.append({"name": key, "value": worst(key), "limit": limits[key],
                           "rule": "at most"})
    ok = True
    for c in checks:
        v = c["value"]
        if c["rule"] == "equal":
            ok &= v == c["limit"]
        elif c["rule"] == "at least":
            ok &= v is not None and v >= c["limit"]
        else:
            ok &= v is not None and v <= c["limit"]
    return bool(ok), checks
