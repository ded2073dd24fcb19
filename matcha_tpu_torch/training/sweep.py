"""Hyperparameter sweeps with a from-scratch TPE sampler.

The port of ``matcha_tpu/training/sweep.py``, pure Python on
``random.Random``: a Tree-structured Parzen Estimator (optuna's default
algorithm: Parzen windows model p(x|good) and p(x|bad) over past trials,
and the candidate with the best ratio wins), plus plain random sampling,
over the ``hparams_search`` config's search space in the override
syntax, optimising its ``optimized_metric``. Each trial's config is
composed anew; the default objective is the port's ``train.train`` (on
the card, or the CPU with ``trainer.accelerator=cpu``).

    python -m matcha_tpu_torch.training.sweep hparams_search=matcha_optuna \\
        experiment=ljspeech trainer.max_steps=200
"""

import math
import random
import re
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple

from matcha_tpu_torch.utils.config import compose
from matcha_tpu_torch.utils.pylogger import get_pylogger

log = get_pylogger(__name__)

_DIST_RE = re.compile(r"(loguniform|uniform|interval|choice)\((.*)\)")


def parse_space(spec: Any) -> Dict[str, Any]:
    """Parse a distribution spec into a structured search space.

    ``loguniform(lo, hi)`` / ``uniform(lo, hi)`` (reference alias:
    ``interval``) / ``choice(a, b, c)``; a plain list is a choice; any
    other value is a fixed constant.
    """
    if isinstance(spec, list):
        return {"kind": "choice", "options": list(spec)}
    m = _DIST_RE.fullmatch(str(spec).strip())
    if not m:
        return {"kind": "const", "value": spec}
    kind, argstr = m.groups()
    args = [a.strip() for a in argstr.split(",")]
    if kind in ("uniform", "interval", "loguniform"):
        return {"kind": "loguniform" if kind == "loguniform" else "uniform",
                "lo": float(args[0]), "hi": float(args[1])}
    return {"kind": "choice", "options": args}


def sample_param(spec: Any, rng: random.Random) -> Any:
    """Sample one value from a distribution spec (random search)."""
    space = parse_space(spec)
    return _sample_space(space, rng)


def _sample_space(space: Dict[str, Any], rng: random.Random) -> Any:
    if space["kind"] == "const":
        return space["value"]
    if space["kind"] == "choice":
        return rng.choice(space["options"])
    lo, hi = space["lo"], space["hi"]
    if space["kind"] == "loguniform":
        return math.exp(rng.uniform(math.log(lo), math.log(hi)))
    return rng.uniform(lo, hi)


class TPESampler:
    """Tree-structured Parzen Estimator (optuna's default, from scratch).

    After ``n_startup`` random trials, observations are split by metric
    into the best ``gamma`` fraction ("good") and the rest ("bad"). Each
    dimension gets two Parzen-window densities l(x)=p(x|good) and
    g(x)=p(x|bad) — Gaussian mixtures over the observed points (in log
    domain for loguniform) plus one domain-wide prior component, Scott's
    rule bandwidth. ``n_candidates`` proposals are drawn from l and the
    one maximizing l(x)/g(x) wins (maximizing expected improvement under
    the TPE identity). Categorical dims use smoothed count ratios.
    """

    def __init__(self, seed: int = 1234, n_startup: int = 5,
                 gamma: float = 0.25, n_candidates: int = 24):
        self.rng = random.Random(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates

    # -- continuous helpers -------------------------------------------------
    @staticmethod
    def _transform(space, x):
        return math.log(x) if space["kind"] == "loguniform" else float(x)

    @staticmethod
    def _untransform(space, t):
        return math.exp(t) if space["kind"] == "loguniform" else t

    @staticmethod
    def _bandwidth(points: List[float], lo: float, hi: float) -> float:
        n = len(points)
        if n > 1:
            mean = sum(points) / n
            std = math.sqrt(sum((p - mean) ** 2 for p in points) / (n - 1))
        else:
            std = 0.0
        scott = 1.06 * max(std, (hi - lo) / 8.0) * n ** (-1 / 5)
        return max(scott, (hi - lo) / 100.0)

    def _density(self, t: float, points: List[float], bw: float,
                 lo: float, hi: float) -> float:
        # mixture of per-point Gaussians + one uniform prior component
        n = len(points)
        total = 1.0 / max(hi - lo, 1e-12)  # the prior
        for p in points:
            z = (t - p) / bw
            total += math.exp(-0.5 * z * z) / (bw * math.sqrt(2 * math.pi))
        return total / (n + 1)

    def _suggest_continuous(self, space, good_t: List[float],
                            bad_t: List[float]) -> float:
        lo = self._transform(space, space["lo"])
        hi = self._transform(space, space["hi"])
        bw_l = self._bandwidth(good_t, lo, hi)
        bw_g = self._bandwidth(bad_t, lo, hi)
        best_t, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            # draw from l(x): a good point jittered by its bandwidth, or
            # the prior component with probability 1/(n_good+1)
            if good_t and self.rng.random() > 1.0 / (len(good_t) + 1):
                t = self.rng.choice(good_t) + self.rng.gauss(0.0, bw_l)
                t = min(max(t, lo), hi)
            else:
                t = self.rng.uniform(lo, hi)
            score = (self._density(t, good_t, bw_l, lo, hi)
                     / max(self._density(t, bad_t, bw_g, lo, hi), 1e-300))
            if score > best_score:
                best_t, best_score = t, score
        return self._untransform(space, best_t)

    def _suggest_choice(self, space, good_v: List[Any], bad_v: List[Any]) -> Any:
        options = space["options"]
        best, best_score = None, -math.inf
        for o in options:
            l = (good_v.count(o) + 1.0) / (len(good_v) + len(options))
            g = (bad_v.count(o) + 1.0) / (len(bad_v) + len(options))
            if l / g > best_score:
                best, best_score = o, l / g
        return best

    # -- public -------------------------------------------------------------
    def suggest(self, spaces: Dict[str, Dict[str, Any]],
                history: List[Tuple[Dict[str, Any], float]]) -> Dict[str, Any]:
        """Propose the next trial's params (minimization)."""
        done = [(p, v) for p, v in history if v == v]  # drop NaN trials
        if len(done) < self.n_startup:
            return {k: _sample_space(s, self.rng) for k, s in spaces.items()}
        done.sort(key=lambda pv: pv[1])
        n_good = max(1, math.ceil(self.gamma * len(done)))
        good = [p for p, _ in done[:n_good]]
        bad = [p for p, _ in done[n_good:]] or good
        out = {}
        for k, space in spaces.items():
            if space["kind"] == "const":
                out[k] = space["value"]
            elif space["kind"] == "choice":
                out[k] = self._suggest_choice(
                    space, [p[k] for p in good], [p[k] for p in bad])
            else:
                out[k] = self._suggest_continuous(
                    space,
                    [self._transform(space, p[k]) for p in good],
                    [self._transform(space, p[k]) for p in bad])
        return out


def run_sweep(base_overrides: List[str],
              objective: Optional[Callable[[Any], Dict[str, float]]] = None,
              ) -> Dict[str, Any]:
    """Run the sweep named by the composed config's ``hparams_search``.

    ``sweeper.kind``: ``tpe`` (default, the optuna-default algorithm),
    ``random``, or ``grid`` (list-valued params). ``objective`` maps a
    composed trial config to a metric dict (defaults to a full training
    run) — injectable for tests and dry runs.
    """
    cfg = compose("train", overrides=base_overrides)
    sweeper = cfg.get("hparams_search", {}).get("sweeper", {})
    metric_name = cfg.get("hparams_search", {}).get("optimized_metric", "loss/val")
    spaces = {k: parse_space(v) for k, v in dict(sweeper.get("params", {})).items()}
    n_trials = int(sweeper.get("n_trials", 5))
    kind = str(sweeper.get("kind", "tpe"))
    seed = int(cfg.get("seed", 1234))
    rng = random.Random(seed)
    sampler = TPESampler(seed=seed,
                         n_startup=int(sweeper.get("n_startup_trials", 5)),
                         gamma=float(sweeper.get("gamma", 0.25)))

    if objective is None:
        from matcha_tpu_torch.train import train

        def objective(trial_cfg):  # noqa: F811 — default: a real training run
            metric_dict, _ = train(trial_cfg)
            return metric_dict

    history: List[Tuple[Dict[str, Any], float]] = []
    best = {"metric": float("inf"), "overrides": None, "params": None}
    for trial in range(n_trials):
        if kind == "tpe":
            params = sampler.suggest(spaces, history)
        else:  # random (grid lists degrade to random choice per trial)
            params = {k: _sample_space(s, rng) for k, s in spaces.items()}
        trial_overrides = list(base_overrides)
        trial_overrides += [f"{k}={v}" for k, v in params.items()]
        trial_overrides.append(f"run_name={cfg.get('run_name', 'sweep')}_t{trial}")
        trial_cfg = compose("train", overrides=trial_overrides)
        log.info(f"[sweep] trial {trial} ({kind}): {params}")
        metric_dict = objective(trial_cfg)
        value = float(metric_dict.get(metric_name, float("nan")))
        log.info(f"[sweep] trial {trial}: {metric_name}={value}")
        history.append((params, value))
        if value == value and value < best["metric"]:
            best = {"metric": value, "overrides": trial_overrides, "params": params}
    log.info(f"[sweep] best {metric_name}={best['metric']}: {best['params']}")
    best["history"] = history
    return best


def main(argv=None) -> None:
    import logging

    logging.basicConfig(level=logging.INFO)
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(o.startswith("hparams_search=") for o in argv):
        argv.append("hparams_search=matcha_optuna")
    run_sweep(argv)


if __name__ == "__main__":
    main()
