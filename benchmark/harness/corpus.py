"""Traffic of kind ``corpus``: staged corpus synthesis, the CLI's
``--batched --staged`` (``TTSPipeline.synthesise_corpus`` with its
defaults: the split decode and vocode, one host copy of a window's
lengths), closed loop, pass after pass.

Each pass is ``utterances`` new texts from the seed (one set of lengths
for every pass and seed, so that each does the same work), mapped to ids
by the system's frontend and synthesised in batches of ``batch_size``; each
batch's mel, waveform and durations come to the host, as the CLI writes
them. The window is ``--seconds`` long; a pass that starts inside it runs
to its end, and its time counts. Each pass's noise comes from one
generator on the device seeded from (``--seed``, the pass), batch after
batch, as the CLI draws it from ``--seed``.

Set-up runs one pass of the same sizes first, which warms every shape
the traffic's buckets reach (cuDNN's and cuFFT's plans, K1's library).
"""

import sys
import time

import numpy as np
import torch

from benchmark.harness import trace
from benchmark.harness.common import derive_seed
from benchmark.harness.textgen import fixed_lengths, make_texts, texts_of_lengths

HOP = 256


class CorpusCell:
    def __init__(self, cell: dict, seed: int, device, traced: bool):
        from benchmark.harness import models

        self.cell, self.seed, self.device, self.traced = cell, seed, device, traced
        cfg, tr = cell["config"], cell["traffic"]
        self.syn = cfg["synthesis"]
        self.spans = trace.Spans(False)
        self.pipeline = models.system_pipeline(cfg, seed, device, cfg["cleaner"])
        # one pass over texts of the traffic's sizes, longest and shortest
        # buckets included, warms every shape a pass can reach
        self._pass(self._texts("warmup", warm=True), torch.Generator(device).manual_seed(0),
                   keep=())
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def _texts(self, p, warm: bool = False) -> list:
        """Pass ``p``'s texts: the mix's one set of lengths (the same for
        every pass and seed), in an order and with words the seed draws."""
        tr = self.cell["traffic"]
        rng = np.random.default_rng(derive_seed(self.seed, "traffic", p))
        lengths = fixed_lengths(tr["name"], tr["utterances"], tr["chars"])
        texts = texts_of_lengths(rng, rng.permutation(lengths))
        if warm:  # both ends of the length range, so the largest buckets are warm
            lo, hi = tr["chars"]["min"], tr["chars"]["max"]
            ends = make_texts(rng, 2 * tr["batch_size"],
                              {"min": hi, "max": hi, "mean": hi, "sd": 0})
            ends[:tr["batch_size"]] = make_texts(rng, tr["batch_size"],
                                                 {"min": lo, "max": lo, "mean": lo, "sd": 0})
            texts = texts[:len(texts) - len(ends)] + ends
        return texts

    def _pass(self, texts: list, gen: torch.Generator, keep) -> dict:
        """One pass; the host lengths of every batch, and the answers of
        the utterance indices in ``keep`` and of the pass's longest."""
        from matcha_tpu_torch.text import intersperse, text_to_sequence

        tr, syn = self.cell["traffic"], self.syn
        cleaner = self.cell["config"]["cleaner"]
        utts = [np.asarray(intersperse(text_to_sequence(t, [cleaner]), 0), np.int32)
                for t in texts]
        batches, kept, longest = [], {}, None
        for chunk, out in self.pipeline.synthesise_corpus(
                utts, n_timesteps=syn["n_timesteps"], temperature=syn["temperature"],
                length_scale=syn["length_scale"], batch_size=tr["batch_size"], generator=gen):
            with self.spans.span("bench.corpus.fetch"):
                wav = out["waveform"].cpu().numpy()
                mel = out["mel"].cpu().numpy()
                dur = out["attn"].sum(-1).cpu().numpy()
            ml = np.asarray(out["mel_lengths_host"])
            bi = len(batches)
            batches.append({"B": len(chunk), "T_y": int(mel.shape[-1]),
                            "T_voc": int(wav.shape[1] // HOP), "mel_lengths": ml.copy()})
            batches[-1]["x_lengths"] = [len(utts[i]) for i in chunk]
            for row, idx in enumerate(chunk):
                n = int(ml[row])
                if idx not in keep and longest is not None and n <= longest["n"]:
                    continue
                ans = {"index": idx, "batch": bi, "row": row, "text": texts[idx],
                       "ids": utts[idx], "n": n, "wav": wav[row, :n * HOP].copy(),
                       "mel": mel[row, :, :n].copy(), "durations": dur[row].copy()}
                if idx in keep:
                    kept[idx] = ans
                if longest is None or n > longest["n"]:
                    longest = ans
        if longest is not None:
            kept[longest["index"]] = longest
        return {"batches": batches, "kept": kept}

    def window(self, seconds: float) -> dict:
        tr = self.cell["traffic"]
        rng = np.random.default_rng(derive_seed(self.seed, "sample"))
        tracer = trace.Trace() if self.traced else None
        self.spans.on = self.traced
        passes, frames = [], 0
        if tracer:
            tracer.__enter__()
        try:
            t0 = time.perf_counter()
            if tracer:
                tracer.mark_start(t0)
            p = 0
            while time.perf_counter() - t0 < seconds:
                texts = self._texts(p)
                gen = torch.Generator(self.device).manual_seed(derive_seed(self.seed, "noise", p))
                keep = {int(rng.integers(len(texts)))}
                with self.spans.span("bench.corpus.pass"):
                    res = self._pass(texts, gen, keep)
                passes.append(res)
                frames += sum(int(b["mel_lengths"].sum()) for b in res["batches"])
                p += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t_end = time.perf_counter()
            if tracer:
                tracer.mark_end(t_end)
                tracer.__exit__(None, None, None)
        except BaseException:
            if tracer:
                tracer.__exit__(*sys.exc_info())
            raise
        self.spans.on = False
        self.passes = passes
        hop_s = HOP / self.cell["config"]["synthesis"]["sample_rate"]
        run = {"kind": "corpus", "seconds": seconds, "window_s": t_end - t0,
               "passes": len(passes), "mel_frames": frames, "audio_s": frames * hop_s,
               "due": len(passes) * tr["utterances"], "answered": len(passes) * tr["utterances"],
               "batches": [b for r in passes for b in r["batches"]]}
        print(f"corpus: {len(passes)} passes of {tr['utterances']} utterances, "
              f"{run['audio_s']:.1f} s of audio in {run['window_s']:.3f} s",
              file=sys.stderr, flush=True)
        if tracer:
            run["trace"] = trace.read(tracer, self.spans)
        return run

    def answers(self) -> list:
        """A sample drawn from the seed (``check_answers`` of the kept
        answers of every pass, and the longest of the window) as rows for
        the reference; each row's noise drawn again from its pass's
        generator."""
        n_check = self.cell["traffic"]["check_answers"]
        rng = np.random.default_rng(derive_seed(self.seed, "sample", "pick"))
        cands = [(p, a) for p, r in enumerate(self.passes) for a in r["kept"].values()]
        if not cands:
            return []
        longest = max(range(len(cands)), key=lambda i: cands[i][1]["n"])
        pick = set(rng.choice(len(cands), size=min(n_check, len(cands)), replace=False).tolist())
        pick.add(longest)
        n_feats = self.cell["config"]["model"]["n_feats"]
        rows = []
        for i in sorted(pick):
            p, a = cands[i]
            batches = self.passes[p]["batches"]
            gen = torch.Generator(self.device).manual_seed(derive_seed(self.seed, "noise", p))
            for b in batches[:a["batch"] + 1]:
                z = torch.randn((b["B"], b["T_y"], n_feats), generator=gen, device=self.device)
            b = batches[a["batch"]]
            rows.append(dict(a, spk=None, T_y=b["T_y"], T_voc=b["T_voc"], noise=z[a["row"]]))
        return rows

    def close(self) -> None:
        pass
