"""The traffic generator: each configuration's pool has the published
dataset's mean nnz and labels, and pads to the slots its cells run at."""
import json

import numpy as np
import pytest
from conftest import ROOT

from perfbench.reference import host
from perfbench.traffic import xml_synth

# a pool large enough that its means sit within a percent or two
CASES = {"xml-amazon-670k": (16384, 256), "xml-delicious-200k": (8192, 1024)}


def _config(name, n):
    config = json.loads((ROOT / f"perfbench/configs/{name}.json").read_text())
    return dict(config, train_samples=n, test_samples=256)


@pytest.mark.parametrize("name", sorted(CASES))
def test_pool_matches_the_published_dataset(name):
    n, slots = CASES[name]
    config = _config(name, n)
    train, test = xml_synth.pools(config, 2**31 + 11, "cpu")
    nnz, labels = np.diff(train["indptr"]), np.diff(train["label_ptr"])
    published = config["published"]
    assert abs(nnz.mean() / published["avg_nnz"] - 1) < 0.03
    assert abs(labels.mean() / published["avg_labels"] - 1) < 0.03
    assert len(test["indptr"]) == 257
    assert train["indices"].dtype == np.int32 and train["values"].dtype == np.float32
    assert 0 <= train["indices"].min() and train["indices"].max() < config["n_features"]
    assert 0 <= train["labels"].min() and train["labels"].max() < config["n_classes"]
    assert nnz.min() >= 1 and nnz.max() <= config["data"]["nnz_clip"][1]
    # features of a sample are distinct and sorted
    starts = train["indptr"][:-1]
    same = np.diff(train["indices"].astype(np.int64))
    inside = np.ones(len(same), bool)
    inside[starts[1:] - 1] = False
    assert (same[inside] > 0).all()
    assert host.padding(train["indptr"], train["label_ptr"])[0] == slots


def test_the_same_seed_draws_the_same_pool():
    config = _config("xml-amazon-670k", 512)
    a, _ = xml_synth.pools(config, 5, "cpu")
    b, _ = xml_synth.pools(config, 5, "cpu")
    c, _ = xml_synth.pools(config, 6, "cpu")
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["indices"][:100], c["indices"][:100])
