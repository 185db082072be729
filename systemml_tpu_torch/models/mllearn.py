# Copy of systemml_tpu/models/mllearn.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch; the scripts run on the device of the
# active config (utils/config.get_config).
"""mllearn: sklearn-style estimators over the DML algorithm library.

TPU-native equivalent of the reference's Scala/Python mllearn estimators
(src/main/scala/org/apache/sysml/api/ml/BaseSystemMLClassifier.scala,
LogisticRegression.scala, LinearRegression.scala, SVM.scala,
NaiveBayes.scala and src/main/python/systemml/mllearn/estimators.py):
fit/predict/score wrappers that drive the production DML scripts through
MLContext, with numpy in/out.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


_ALGO_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..",
    "scripts", "algorithms"))


def _run(script: str, inputs: Dict, args: Dict, outputs):
    from systemml_tpu_torch.api.mlcontext import MLContext, dmlFromFile
    from systemml_tpu_torch.utils.config import get_config

    s = dmlFromFile(os.path.join(_ALGO_DIR, script))
    for k, v in inputs.items():
        s.input(k, v)
    for k, v in (args or {}).items():
        s.arg(k, v)
    s.output(*outputs)
    return MLContext(get_config().copy()).execute(s)


class _Base:
    def get_params(self) -> Dict:
        return dict(self._args)

    def set_params(self, **kw) -> "_Base":
        self._args.update(kw)
        return self


class LogisticRegression(_Base):
    """Multinomial logistic regression via MultiLogReg.dml (reference:
    ml/LogisticRegression.scala; trust-region IRLS in the script)."""

    def __init__(self, reg: float = 1e-3, max_iter: int = 50,
                 fit_intercept: bool = True):
        self._args = {"reg": reg, "moi": max_iter,
                      "icpt": 1 if fit_intercept else 0}
        self.coef_: Optional[np.ndarray] = None

    def fit(self, X, y):
        y = np.asarray(y, dtype=float).reshape(-1, 1)
        self._classes = np.unique(y)
        ymap = {c: i + 1.0 for i, c in enumerate(self._classes)}
        r = _run("MultiLogReg.dml",
                 {"X": np.asarray(X, dtype=float),
                  "Y_vec": np.vectorize(ymap.get)(y)}, self._args, ["B"])
        self.coef_ = r.get_matrix("B")
        return self

    def _scores(self, X):
        X = np.asarray(X, dtype=float)
        if self._args["icpt"] == 1:
            X = np.hstack([X, np.ones((X.shape[0], 1))])
        return X @ self.coef_

    def predict_proba(self, X):
        s = self._scores(X)
        e = np.exp(s - s.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    def predict(self, X):
        return self._classes[self._scores(X).argmax(axis=1)]

    def score(self, X, y) -> float:
        return float((self.predict(X) ==
                      np.asarray(y).reshape(-1)).mean())


class LinearRegression(_Base):
    """Linear regression via LinearRegCG.dml / LinearRegDS.dml
    (reference: ml/LinearRegression.scala solver switch)."""

    def __init__(self, solver: str = "newton-cg", reg: float = 1e-6,
                 max_iter: int = 100, tol: float = 1e-9,
                 fit_intercept: bool = True):
        self.script = ("LinearRegDS.dml" if solver in ("direct-solve", "ds")
                       else "LinearRegCG.dml")
        self._args = {"reg": reg, "tol": tol,
                      "icpt": 1 if fit_intercept else 0}
        if self.script == "LinearRegCG.dml":
            self._args["maxi"] = max_iter
        self.coef_: Optional[np.ndarray] = None

    def fit(self, X, y):
        r = _run(self.script,
                 {"X": np.asarray(X, dtype=float),
                  "y": np.asarray(y, dtype=float).reshape(-1, 1)},
                 self._args, ["beta"])
        self.coef_ = r.get_matrix("beta")
        return self

    def predict(self, X):
        X = np.asarray(X, dtype=float)
        if self._args["icpt"] == 1:
            X = np.hstack([X, np.ones((X.shape[0], 1))])
        return X @ self.coef_

    def score(self, X, y) -> float:
        """R^2 (sklearn convention)."""
        y = np.asarray(y, dtype=float).reshape(-1, 1)
        resid = y - self.predict(X)
        ss_res = float((resid ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum())
        return 1.0 - ss_res / max(ss_tot, 1e-300)


class SVM(_Base):
    """l2-svm (binary) or m-svm (multiclass) by label count (reference:
    ml/SVM.scala is_multi_class switch)."""

    def __init__(self, reg: float = 1e-2, max_iter: int = 100,
                 fit_intercept: bool = True, is_multi_class: bool = False):
        self._args = {"reg": reg, "maxiter": max_iter,
                      "icpt": 1 if fit_intercept else 0}
        self.is_multi_class = is_multi_class
        self.coef_: Optional[np.ndarray] = None

    def fit(self, X, y):
        y = np.asarray(y, dtype=float).reshape(-1, 1)
        classes = np.unique(y)
        self._classes = classes
        multi = self.is_multi_class or len(classes) > 2
        self._multi = multi
        if multi:
            # m-svm wants labels 1..K
            ymap = {c: i + 1 for i, c in enumerate(classes)}
            y2 = np.vectorize(ymap.get)(y)
            r = _run("m-svm.dml", {"X": np.asarray(X, dtype=float),
                                   "Y": y2.astype(float)},
                     self._args, ["W"])
            self.coef_ = r.get_matrix("W")
        else:
            # l2-svm wants -1/+1
            y2 = np.where(y == classes.max(), 1.0, -1.0)
            r = _run("l2-svm.dml", {"X": np.asarray(X, dtype=float),
                                    "Y": y2}, self._args, ["w"])
            self.coef_ = r.get_matrix("w")
        return self

    def predict(self, X):
        X = np.asarray(X, dtype=float)
        if self._args["icpt"] == 1:
            X = np.hstack([X, np.ones((X.shape[0], 1))])
        s = X @ self.coef_
        if self._multi:
            return self._classes[s.argmax(axis=1)]
        return np.where(s.ravel() > 0, self._classes.max(),
                        self._classes.min())

    def score(self, X, y) -> float:
        return float((self.predict(X) ==
                      np.asarray(y).reshape(-1)).mean())


class NaiveBayes(_Base):
    """Multinomial naive Bayes via naive-bayes.dml (reference:
    ml/NaiveBayes.scala)."""

    def __init__(self, laplace: float = 1.0):
        self._args = {"laplace": laplace}
        self.class_prior_: Optional[np.ndarray] = None
        self.class_conditionals_: Optional[np.ndarray] = None

    def fit(self, X, y):
        y = np.asarray(y, dtype=float).reshape(-1, 1)
        classes = np.unique(y)
        self._classes = classes
        ymap = {c: i + 1 for i, c in enumerate(classes)}
        y2 = np.vectorize(ymap.get)(y).astype(float)
        r = _run("naive-bayes.dml",
                 {"X": np.asarray(X, dtype=float), "Y": y2}, self._args,
                 ["class_prior", "class_conditionals"])
        self.class_prior_ = r.get_matrix("class_prior")
        self.class_conditionals_ = r.get_matrix("class_conditionals")
        return self

    def predict(self, X):
        X = np.asarray(X, dtype=float)
        logp = (X @ np.log(self.class_conditionals_.T)
                + np.log(self.class_prior_.reshape(1, -1)))
        return self._classes[logp.argmax(axis=1)]

    def score(self, X, y) -> float:
        return float((self.predict(X) ==
                      np.asarray(y).reshape(-1)).mean())
