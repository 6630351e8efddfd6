"""Data files decode as UTF-8 whatever the host's locale says.

The JAX package opens data files with ``encoding="utf-8"``
(wide_deep_tpu/features/fs.py ``open_text``); the port's ``CsvDataset``
must too, or on a host whose locale is not UTF-8 a non-ASCII feature value
decodes to other characters and hashes to other ids.  Both loaders read one
TSV with non-ASCII categorical cells in a child process under ``LC_ALL=C``
with Python's UTF-8 mode off, and their batches must be equal.
"""

import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from paths import REPO, TRAIN1  # noqa: E402
from test_torch_features import write_conf  # noqa: E402

CHILD = r"""
import locale
import sys
import numpy as np
from test_torch_features import plan_pair
from wide_deep_tpu.features.pipeline import CsvDataset as JD
from wide_deep_tpu.features.pipeline import FeatureTransformer as JT
from wide_deep_tpu_torch.features.pipeline import CsvDataset as TD

enc = locale.getpreferredencoding(False)
assert enc.lower().replace("-", "") != "utf8" and not sys.flags.utf8_mode, enc
conf_dir, tsv = sys.argv[1:3]
jp, tp = plan_pair(conf_dir)
jb = next(iter(JD(jp, tsv, "train", 48, shuffle_buffer=0,
                  transformer=JT(jp))))
tb = next(iter(TD(tp, tsv, "train", 48, shuffle_buffer=0)))
assert sorted(jb) == sorted(tb)
for k in jb:
    np.testing.assert_array_equal(jb[k], tb[k], err_msg=k)
print("batches equal")
"""


def test_loaders_read_utf8_under_c_locale(tmp_path):
    conf_dir = write_conf(tmp_path / "conf")
    # both packages read their yaml with the locale's codec, as the TF
    # reference did: keep the config itself ASCII
    for name in os.listdir(conf_dir):
        path = os.path.join(conf_dir, name)
        with open(path, encoding="utf-8") as f:
            text = f.read()
        with open(path, "wb") as f:
            f.write(text.encode("ascii", "ignore"))
    with open(TRAIN1, encoding="utf-8") as f:
        lines = [line.rstrip("\n") for line in f if line.strip()][:40]
    # hashed categorical values ("ad1", "ci328", "us9,us10") gain non-ASCII
    # characters
    rows = ["\t".join(",".join(v + "é日" if re.fullmatch(r"[a-z]+\d+", v)
                                else v for v in cell.split(","))
                       for cell in line.split("\t")) for line in lines]
    tsv = tmp_path / "train.tsv"
    tsv.write_bytes(("\n".join(rows) + "\n").encode("utf-8"))
    env = dict(os.environ, LC_ALL="C", LANG="C", PYTHONUTF8="0",
               PYTHONCOERCECLOCALE="0", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
    env.pop("PYTHONIOENCODING", None)
    proc = subprocess.run([sys.executable, "-c", CHILD, conf_dir, str(tsv)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "batches equal" in proc.stdout
