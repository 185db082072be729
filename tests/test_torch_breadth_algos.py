"""The algorithm scripts that the breadth builtins (seq, sample, table,
order, removeEmpty, outer, the cumulative and index aggregates, the
distributions, the linear algebra) let the port run, through the port's
MLContext(device="cpu") against the JAX package's, at optlevels 2 and 3,
on small numpy-seeded inputs. Bar: relative 1e-9 in fp64 (each output's
largest difference over max(1, its largest value)).

Kmeans runs with the k-means++ init over a sample (samp 50: seq,
rexpand, cumsum, seeded rand) and with the plain init (samp 0: sample),
its while loop one region; the rest: Kmeans-predict, m-svm and its
predict script, l2-svm-predict, naive-bayes and its predict script, PCA,
StepLinearRegDS, CsplineDS and CsplineCG, GLM-predict, Cox and
Cox-predict, KM, ALS_predict and ALS_topk_predict, decision-tree and its
predict script, random-forest-predict (its model trained by the JAX
package: random-forest.dml needs parfor), bivar-stats and stratstats.
"""

import numpy as np
import pytest

from tests.test_torch_breadth_scripts import rel, run_script


def _data():
    rng = np.random.default_rng(5)
    n, m = 120, 5
    x = rng.standard_normal((n, m))
    b = rng.standard_normal((m, 1))
    y = x @ b + 0.1 * rng.standard_normal((n, 1))
    ycls = (np.argmax(x[:, :3], axis=1) + 1).reshape(-1, 1).astype(float)
    xc = np.ceil(np.abs(x) * 2) + 1
    cox = np.column_stack([rng.exponential(1, n),
                           (rng.random(n) < .7).astype(float), x[:, :3]])
    km = np.column_stack([rng.exponential(1, n) + .01,
                          (rng.random(n) < .7).astype(float),
                          rng.integers(1, 3, n).astype(float)])
    kx = np.sort(rng.uniform(0, 10, 12)).reshape(-1, 1)
    q = np.linspace(1, 9, 7).reshape(-1, 1)
    blobs = np.concatenate([rng.standard_normal((40, 3)) + c
                            for c in (0.0, 6.0, -6.0)])
    return {
        "Kmeans": ("Kmeans.dml", {"X": blobs},
                   {"k": 3, "runs": 2, "maxi": 10}, ["C_out"]),
        "Kmeans-plain-init": ("Kmeans.dml", {"X": blobs},
                              {"k": 3, "runs": 2, "maxi": 10, "samp": 0},
                              ["C_out"]),
        "Kmeans-isY": ("Kmeans.dml", {"X": blobs},
                       {"k": 4, "runs": 1, "maxi": 20, "isY": 1},
                       ["C_out", "Y_out"]),
        "Kmeans-predict": ("Kmeans-predict.dml", {"X": x, "C": x[:3]}, None,
                           ["prY"]),
        "m-svm": ("m-svm.dml", {"X": x, "Y": ycls}, {"maxiter": 5}, ["W"]),
        "m-svm-predict": ("m-svm-predict.dml",
                          {"X": x, "W": rng.standard_normal((m, 3)),
                           "Y": ycls}, None, ["scores"]),
        "l2-svm-predict": ("l2-svm-predict.dml",
                           {"X": x, "w": b, "Y": np.sign(y)}, None,
                           ["scores"]),
        "naive-bayes": ("naive-bayes.dml", {"X": xc, "Y": ycls}, None,
                        ["class_prior", "class_conditionals"]),
        "naive-bayes-predict": ("naive-bayes-predict.dml",
                                {"X": xc, "prior": [[.3], [.3], [.4]],
                                 "conditionals": rng.random((3, m)),
                                 "Y": ycls}, None, ["pred"]),
        "PCA": ("PCA.dml", {"X": x}, {"K": 3}, ["eval_top"]),
        "StepLinearRegDS": ("StepLinearRegDS.dml", {"X": x, "y": y},
                            {"icpt": 0}, ["beta_final"]),
        "CsplineDS": ("CsplineDS.dml", {"X": kx, "Y": np.sin(kx), "Q": q},
                      None, ["pred_y"]),
        "CsplineCG": ("CsplineCG.dml", {"X": kx, "Y": np.sin(kx), "Q": q},
                      None, ["pred_y"]),
        "GLM-predict": ("GLM-predict.dml",
                        {"X": x, "B": 0.3 * b,
                         "Y": rng.poisson(np.exp(0.3 * x @ b)).astype(float)},
                        {"dfam": 1, "vpow": 1.0, "link": 1, "lpow": 0.0},
                        ["M"]),
        "Cox": ("Cox.dml", {"X": cox}, {"moi": 20}, ["M", "S", "T"]),
        "Cox-predict": ("Cox-predict.dml",
                        {"X": cox, "B": b[:3], "Xn": cox[:10]}, None, ["P"]),
        "KM": ("KM.dml", {"X": km}, None, ["KM", "M", "T"]),
        "ALS_predict": ("ALS_predict.dml",
                        {"X": [[1.0, 2.0], [3.0, 4.0]],
                         "L": rng.standard_normal((12, 2)),
                         "R": rng.standard_normal((20, 2))}, None, ["Y_out"]),
        "ALS_topk_predict": ("ALS_topk_predict.dml",
                             {"X": [[1.0], [5.0]],
                              "L": rng.standard_normal((12, 2)),
                              "R": rng.standard_normal((20, 2)),
                              "V": np.zeros((12, 20))}, {"K": 4},
                             ["VTopIndexes", "VTopValues"]),
        "decision-tree": ("decision-tree.dml", {"X": blobs,
                                                "Y": 1.0 + np.repeat(
                                                    np.arange(3.0), 40)[:,
                                                                        None]},
                          {"depth": 3, "num_leaf": 5}, ["M"]),
        "bivar-stats": ("bivar-stats.dml",
                        {"X": xc, "index1": [[1.0, 2.0]],
                         "index2": [[3.0, 4.0]], "types1": [[1.0, 2.0]],
                         "types2": [[1.0, 2.0]]}, None,
                        ["bivar_ss", "bivar_nn", "bivar_ns"]),
        "stratstats": ("stratstats.dml",
                       {"X": x, "Y": y, "Sm": np.ceil(np.abs(x[:, :1]) + 1)},
                       None, ["O"]),
    }


CASES = _data()


@pytest.mark.parametrize("optlevel", [2, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_script_matches_jax(name, optlevel):
    script, inputs, args, outs = CASES[name]
    got, _, _ = run_script(script, inputs, args, outs, optlevel)
    ref, _, _ = run_script(script, inputs, args, outs, optlevel, port=False)
    for o in outs:
        assert rel(got[o], ref[o]) <= 1e-9, o


@pytest.mark.parametrize("samp", [50, 0])
def test_kmeans_while_loop_is_one_region(samp):
    """Kmeans's while loop (rowIndexMax, rowMins, rexpand) runs as a
    region, not refused: rexpand's target, the loop's cluster ids, is a
    value, and only its max sizes the output; its optlevel 3 result
    equals its optlevel 2 result."""
    script, inputs, args, outs = CASES["Kmeans"]
    args = dict(args, samp=samp)
    got, stats, events = run_script(script, inputs, args, outs, 3)
    assert events == []
    lines = [ln for ln in stats.display().split("\n")
             if ln.startswith("Loop regions")]
    assert lines and "refused=0" in lines[0] and "while[C,delta,iter" \
        in lines[0], lines
    plain, _, _ = run_script(script, inputs, args, outs, 2)
    assert rel(got["C_out"], plain["C_out"]) <= 1e-9


def test_decision_tree_predict_and_random_forest_predict():
    """The predict scripts on models the training scripts made: the port's
    decision-tree model, and a random-forest model trained by the JAX
    package (random-forest.dml's ensemble loop is a parfor)."""
    script, inputs, args, _ = CASES["decision-tree"]
    model, _, _ = run_script(script, inputs, args, ["M"], 3)
    x = inputs["X"]
    for opt in (2, 3):
        got, _, _ = run_script("decision-tree-predict.dml",
                               {"X": x, "M": model["M"]}, {"depth": 3},
                               ["P"], opt)
        ref, _, _ = run_script("decision-tree-predict.dml",
                               {"X": x, "M": model["M"]}, {"depth": 3},
                               ["P"], opt, port=False)
        assert rel(got["P"], ref["P"]) == 0.0
    forest, _, _ = run_script("random-forest.dml",
                              {"X": x, "Y": inputs["Y"]},
                              {"depth": 3, "num_trees": 3}, ["M"], 2,
                              port=False)
    for opt in (2, 3):
        args = {"num_trees": 3}
        got, _, _ = run_script("random-forest-predict.dml",
                               {"X": x, "M": forest["M"]}, args, ["P"], opt)
        ref, _, _ = run_script("random-forest-predict.dml",
                               {"X": x, "M": forest["M"]}, args, ["P"], opt,
                               port=False)
        assert rel(got["P"], ref["P"]) == 0.0
