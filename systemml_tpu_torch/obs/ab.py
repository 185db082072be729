# Copy of systemml_tpu/obs/ab.py for the PyTorch port: the same code (it
# imports nothing of either package); codegen/tune.py measures with it.
"""In-session interleaved A/B benchmarking.

The artifact class this module exists to kill: a benchmark dividing a
fresh measurement by a REFERENT CONSTANT measured days earlier under
different conditions (bench.py's former ``imgs / 4335.0``). On a shared
or tunneled chip the denominator's conditions are unrecoverable, so the
ratio cannot distinguish a real regression from background starvation.

Protocol (TVM-style measurement discipline applied to A-vs-B):

1. both arms run IN THE SAME SESSION, warmup first;
2. N alternating trials, order flipped each round (A,B / B,A / ...), so
   slow drift — thermal, co-tenant load — hits both arms equally;
3. the per-arm center is a trimmed mean; the reported ratio is the
   median of bootstrap-resampled trimmed means of the PER-TRIAL ratios
   (median-of-trimmed-means — robust to a single stalled trial, and
   paired so the correlated drift that interleaving exists to cancel
   actually cancels);
4. the verdict REFUSES to pick a winner when the evidence is weak:
   "inconclusive" whenever the ratio's confidence interval spans 1.0
   (for unpaired sample sets, per-arm interval overlap also refuses).

No numpy/scipy dependency: the module imports standalone.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

VERDICT_A = "A"
VERDICT_B = "B"
INCONCLUSIVE = "inconclusive"


def trimmed_mean(xs: Sequence[float], trim: float = 0.2) -> float:
    """Mean of the central (1 - 2*trim) fraction. With few samples the
    trim floor keeps at least one value (n<=2: plain mean)."""
    s = sorted(float(x) for x in xs)
    if not s:
        raise ValueError("no samples")
    k = int(len(s) * trim)
    if len(s) - 2 * k < 1:
        k = max(0, (len(s) - 1) // 2)
    core = s[k:len(s) - k] if k else s
    return sum(core) / len(core)


@dataclasses.dataclass
class ABResult:
    a_samples: List[float]
    b_samples: List[float]
    a_center: float
    b_center: float
    a_ci: Tuple[float, float]
    b_ci: Tuple[float, float]
    ratio: float                # A / B (bootstrap median)
    ratio_ci: Tuple[float, float]
    verdict: str                # "A" | "B" | "inconclusive"
    confidence: float
    higher_is_better: bool

    @property
    def conclusive(self) -> bool:
        return self.verdict != INCONCLUSIVE

    def to_dict(self) -> Dict[str, Any]:
        return {
            "ratio": round(self.ratio, 4),
            "ratio_ci": [round(self.ratio_ci[0], 4),
                         round(self.ratio_ci[1], 4)],
            "verdict": self.verdict,
            "confidence": self.confidence,
            "a": {"center": self.a_center,
                  "ci": [self.a_ci[0], self.a_ci[1]],
                  "n": len(self.a_samples)},
            "b": {"center": self.b_center,
                  "ci": [self.b_ci[0], self.b_ci[1]],
                  "n": len(self.b_samples)},
        }

    def __str__(self):
        better = {VERDICT_A: "A better", VERDICT_B: "B better",
                  INCONCLUSIVE: "inconclusive (intervals overlap)"}
        return (f"A/B = {self.ratio:.4f} "
                f"[{self.ratio_ci[0]:.4f}, {self.ratio_ci[1]:.4f}] "
                f"@{self.confidence:.0%} -> {better[self.verdict]}")


def _bootstrap_centers(xs: Sequence[float], trim: float, n_boot: int,
                       rng: random.Random) -> List[float]:
    n = len(xs)
    out = []
    for _ in range(n_boot):
        res = [xs[rng.randrange(n)] for _ in range(n)]
        out.append(trimmed_mean(res, trim))
    out.sort()
    return out


def _pct(sorted_xs: List[float], q: float) -> float:
    if not sorted_xs:
        return math.nan
    i = min(len(sorted_xs) - 1, max(0, int(q * (len(sorted_xs) - 1))))
    return sorted_xs[i]


def compare_samples(a: Sequence[float], b: Sequence[float],
                    higher_is_better: bool = True,
                    confidence: float = 0.95, trim: float = 0.2,
                    n_boot: int = 2000, seed: int = 0xAB,
                    paired: Optional[bool] = None) -> ABResult:
    """Judge two sample sets already collected (e.g. by a child process
    that interleaved the runs itself). Deterministic: the bootstrap RNG
    is seeded.

    By default equal-length sample sets are treated as PAIRED (trial i
    of A ran next to trial i of B — what interleave() produces): the
    ratio is bootstrapped over per-trial ratios, so correlated drift
    that moves both arms together cancels instead of widening the
    interval — the whole reason the harness interleaves. Unequal
    lengths fall back to independent per-arm bootstraps, where
    non-overlap of the arm intervals is additionally required. Pass
    ``paired=False`` when equal-length sets did NOT run interleaved
    (e.g. bench_compare judging this run against a committed baseline):
    pretending such sets are paired would fabricate drift cancellation
    that never happened."""
    a = [float(x) for x in a]
    b = [float(x) for x in b]
    if not a or not b:
        raise ValueError("both sample sets must be non-empty")
    if paired and len(a) != len(b):
        raise ValueError("paired=True requires equal-length sample sets")
    rng = random.Random(seed)
    lo_q, hi_q = (1 - confidence) / 2, 1 - (1 - confidence) / 2
    boot_a = _bootstrap_centers(a, trim, n_boot, rng)
    boot_b = _bootstrap_centers(b, trim, n_boot, rng)
    a_ci = (_pct(boot_a, lo_q), _pct(boot_a, hi_q))
    b_ci = (_pct(boot_b, lo_q), _pct(boot_b, hi_q))
    if paired is None:
        paired = len(a) == len(b)
    if paired:
        per_trial = [x / y if y else math.inf for x, y in zip(a, b)]
        ratios = _bootstrap_centers(per_trial, trim, n_boot, rng)
    else:
        ratios = []
        for _ in range(n_boot):
            x = boot_a[rng.randrange(n_boot)]
            y = boot_b[rng.randrange(n_boot)]
            ratios.append(x / y if y else math.inf)
        ratios.sort()
    ratio_ci = (_pct(ratios, lo_q), _pct(ratios, hi_q))
    ratio = _pct(ratios, 0.5)  # median-of-trimmed-means
    # per-arm overlap is only a valid refusal criterion for UNPAIRED
    # arms: paired arms can overlap marginally while every single trial
    # agrees on the direction
    overlap = (not paired
               and not (a_ci[0] > b_ci[1] or b_ci[0] > a_ci[1]))
    if len(a) < 2 or len(b) < 2:
        # one sample has no variance estimate: a zero-width bootstrap CI
        # would fabricate certainty — a single-trial run only reports
        verdict = INCONCLUSIVE
    elif overlap or (ratio_ci[0] <= 1.0 <= ratio_ci[1]):
        verdict = INCONCLUSIVE
    elif (ratio > 1.0) == higher_is_better:
        verdict = VERDICT_A
    else:
        verdict = VERDICT_B
    return ABResult(a, b, trimmed_mean(a, trim), trimmed_mean(b, trim),
                    a_ci, b_ci, ratio, ratio_ci, verdict, confidence,
                    higher_is_better)


def ci_of(samples: Sequence[float], confidence: float = 0.95,
          trim: float = 0.2, n_boot: int = 2000,
          seed: int = 0xAB) -> Tuple[float, Tuple[float, float]]:
    """Single-arm center + bootstrap CI (no referent): the one-sided
    sibling of compare_samples for metrics reported without an A/B."""
    xs = [float(x) for x in samples]
    if not xs:
        raise ValueError("no samples")
    rng = random.Random(seed)
    boot = _bootstrap_centers(xs, trim, n_boot, rng)
    lo_q, hi_q = (1 - confidence) / 2, 1 - (1 - confidence) / 2
    return trimmed_mean(xs, trim), (_pct(boot, lo_q), _pct(boot, hi_q))


def interleave(run_a: Callable[[], Any], run_b: Callable[[], Any],
               trials: int = 5, warmup: int = 1, mode: str = "auto",
               numeric_compat: bool = False
               ) -> Tuple[List[float], List[float]]:
    """Collect interleaved samples. Each runner either RETURNS its own
    measured sample (an int/float — for runners that handle device sync
    and report a throughput) or is wall-clock timed here (returns
    anything else; the sample is elapsed seconds). BOTH arms must use
    the same mode — mixing a self-measured throughput against elapsed
    seconds would produce a unit-less nonsense ratio, so that raises.
    The order flips each round so a monotonic drift cannot
    systematically favor one arm.

    ``mode`` declares the measurement intent and guards the classic
    pitfall where an arm MEANT to be wall-clock timed incidentally
    returns a number (a loop count, a fetched loss) and that number is
    silently promoted to a self-measured sample:

    - ``"wall"`` — arms are wall-clock timed; a numeric return RAISES
      (or, under ``numeric_compat=True``, warns loudly, discards the
      return value and wall-clock times the arm anyway);
    - ``"self"`` — arms report their own samples; a non-numeric return
      raises;
    - ``"auto"`` (default, compat) — infer per-sample as before, but
      warn once when numeric returns are being promoted, so undeclared
      call sites surface instead of silently self-measuring.
    """
    if mode not in ("auto", "wall", "self"):
        raise ValueError(f"interleave: mode must be auto|wall|self, "
                         f"got {mode!r}")
    modes = set()
    warned = [False]

    def one(fn) -> float:
        t0 = time.perf_counter()
        v = fn()
        dt = time.perf_counter() - t0
        numeric = isinstance(v, (int, float)) and not isinstance(v, bool)
        if mode == "wall":
            if numeric:
                if not numeric_compat:
                    raise ValueError(
                        "interleave(mode='wall'): a wall-clock-timed arm "
                        f"returned a numeric value ({v!r}) — that return "
                        "would silently become a self-measured sample. "
                        "Return None from wall-clock arms (or declare "
                        "mode='self' if the arm really reports its own "
                        "samples; numeric_compat=True to discard the "
                        "return and time anyway).")
                if not warned[0]:
                    warned[0] = True
                    import warnings

                    warnings.warn(
                        "interleave(mode='wall', numeric_compat=True): "
                        f"discarding numeric arm return {v!r} and "
                        "wall-clock timing the arm", RuntimeWarning,
                        stacklevel=3)
            return dt
        if mode == "self":
            if not numeric:
                raise ValueError(
                    "interleave(mode='self'): a self-measured arm "
                    f"returned {type(v).__name__}, not a numeric sample")
            return float(v)
        # auto: infer per sample (legacy behavior), loudly
        if numeric:
            modes.add("self-measured")
            sample = float(v)
            if not warned[0]:
                warned[0] = True
                import warnings

                warnings.warn(
                    "interleave(mode='auto'): numeric arm returns are "
                    "being treated as self-measured samples — declare "
                    "mode='self' (or mode='wall' and return None) to "
                    "make the intent explicit", UserWarning, stacklevel=3)
        else:
            modes.add("wall-clock")
            sample = dt
        if len(modes) > 1:
            # fail on the FIRST inconsistent sample, not after every
            # (possibly minutes-long) trial has run and must be discarded
            raise ValueError(
                "interleave: arms mixed self-measured and wall-clock "
                "samples — their units are incomparable")
        return sample

    for _ in range(max(0, warmup)):
        # warmup routes through one() (samples discarded) so a
        # wall-mode numeric return fails BEFORE minutes of trials run
        one(run_a)
        one(run_b)
    sa: List[float] = []
    sb: List[float] = []
    for i in range(max(1, trials)):
        order = ((run_a, sa), (run_b, sb)) if i % 2 == 0 else \
            ((run_b, sb), (run_a, sa))
        for fn, acc in order:
            acc.append(one(fn))
    return sa, sb


def ab(run_a: Callable[[], Any], run_b: Callable[[], Any],
       trials: int = 5, warmup: int = 1, higher_is_better: bool = True,
       confidence: float = 0.95, trim: float = 0.2,
       mode: str = "auto") -> ABResult:
    """The full harness: interleave, then judge. NOTE higher_is_better
    refers to the SAMPLES (throughputs: True; wall-clock timings:
    False)."""
    sa, sb = interleave(run_a, run_b, trials=trials, warmup=warmup,
                        mode=mode)
    return compare_samples(sa, sb, higher_is_better=higher_is_better,
                           confidence=confidence, trim=trim)
