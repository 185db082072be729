"""Model APIs: the reference's DL + mllearn estimator layer.

* NetSpec / Caffe2DML / Keras2DML — layer graph -> generated DML over
  scripts/nn (reference: src/main/scala/org/apache/sysml/api/dl/)
* mllearn — sklearn-style wrappers over scripts/algorithms (reference:
  src/main/scala/org/apache/sysml/api/ml/, python mllearn package)
"""

from systemml_tpu_torch.models.netspec import Layer, NetSpec, NetSpecError
from systemml_tpu_torch.models.estimators import Caffe2DML, Keras2DML
from systemml_tpu_torch.models.mllearn import (LinearRegression,
                                         LogisticRegression, NaiveBayes,
                                         SVM)

__all__ = ["Layer", "NetSpec", "NetSpecError", "Caffe2DML", "Keras2DML",
           "LinearRegression", "LogisticRegression", "NaiveBayes", "SVM"]
