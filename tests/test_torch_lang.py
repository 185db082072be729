"""The port's copy of the DML front end (systemml_tpu_torch/lang) against
the JAX package's: every script under scripts/algorithms/ parses through
both and unparses to the same text (the pattern of tests/test_unparse.py).
Bar: exact text equality."""

import glob
import os

import pytest

from systemml_tpu.lang.parser import parse as jparse
from systemml_tpu.lang.unparse import unparse_program as junparse
from systemml_tpu_torch.lang.parser import parse as pparse
from systemml_tpu_torch.lang.unparse import unparse_program as punparse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = sorted(glob.glob(os.path.join(ROOT, "scripts", "algorithms",
                                        "*.dml")))


def test_corpus_is_there():
    assert len(SCRIPTS) >= 30


@pytest.mark.parametrize("path", SCRIPTS, ids=os.path.basename)
def test_same_unparse_text(path):
    with open(path) as f:
        src = f.read()
    assert punparse(pparse(src)) == junparse(jparse(src))
