"""libSVM I/O (``data.libsvm``, copied from the reference's) against the
reference's: files written by either package are byte-identical (the
``:.6g`` values and the optional header included), and a file either
package wrote reads back in both to equal arrays. The tests make their own
data (``make_xml_dataset`` or numpy) in a temporary directory."""
from __future__ import annotations

import numpy as np
import pytest

from repro.data import libsvm as jlibsvm
from repro.data.sparse import SparseDataset as JSparseDataset
from repro.data.xml_synth import make_xml_dataset as jax_make_dataset
from repro_torch.data import libsvm
from repro_torch.data.sparse import SparseDataset
from repro_torch.data.xml_synth import make_xml_dataset

FIELDS = ("indptr", "indices", "values", "label_ptr", "labels")


def assert_datasets_equal(a, b):
    assert (a.n_features, a.n_classes) == (b.n_features, b.n_classes)
    for k in FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def odd_arrays() -> dict:
    """Four samples: one with no labels, one with no features, one with
    several of each, one with a single label and feature."""
    return dict(
        n_features=50, n_classes=9,
        indptr=np.array([0, 3, 3, 7, 8], np.int64),
        indices=np.array([4, 17, 49, 0, 2, 3, 40, 11], np.int32),
        values=np.array([0.5, 1e-7, 123456.789, 2.0, -0.25, 3.14159265, 1.0, 7.5], np.float32),
        label_ptr=np.array([0, 0, 2, 5, 6], np.int64),
        labels=np.array([1, 8, 0, 3, 4, 2], np.int32),
    )


def datasets(kind):
    if kind == "xml_synth":
        kw = dict(n_samples=120, n_features=300, n_classes=40, avg_nnz=12, seed=2)
        return make_xml_dataset(**kw), jax_make_dataset(**kw)
    return SparseDataset(**odd_arrays()), JSparseDataset(**odd_arrays())


@pytest.mark.parametrize("header", [True, False], ids=["header", "no_header"])
@pytest.mark.parametrize("kind", ["xml_synth", "odd_samples"])
def test_written_files_are_byte_identical_and_read_back_both_ways(tmp_path, kind, header):
    ds, jds = datasets(kind)
    path, jpath = tmp_path / "port.svm", tmp_path / "ref.svm"
    libsvm.write_libsvm(ds, str(path), header=header)
    jlibsvm.write_libsvm(jds, str(jpath), header=header)
    assert path.read_bytes() == jpath.read_bytes()
    # either file, read by either package, gives the same arrays
    for p in (path, jpath):
        got = libsvm.read_libsvm(str(p))
        want = jlibsvm.read_libsvm(str(p))
        assert_datasets_equal(got, want)
        assert got.n_samples == ds.n_samples
        np.testing.assert_array_equal(got.indices, ds.indices)
        np.testing.assert_array_equal(got.labels, ds.labels)
        # the values are the :.6g text's
        np.testing.assert_allclose(got.values, ds.values, rtol=5e-6)
        if header:
            assert (got.n_features, got.n_classes) == (ds.n_features, ds.n_classes)
    # written again from what was read, the file is unchanged
    again = tmp_path / "again.svm"
    libsvm.write_libsvm(libsvm.read_libsvm(str(path)), str(again), header=header)
    assert again.read_bytes() == path.read_bytes()


def test_reads_blank_lines_explicit_sizes_and_a_headerless_first_sample(tmp_path):
    text = "3,1 0:1.5 7:2\n\n  \n 2:0.5 9:1e-05\n4\n\n0,2 5:-3\n"
    path = tmp_path / "hand.svm"
    path.write_text(text)
    for kw in ({}, dict(n_features=20, n_classes=6)):
        got = libsvm.read_libsvm(str(path), **kw)
        assert_datasets_equal(got, jlibsvm.read_libsvm(str(path), **kw))
        assert got.n_samples == 4
        assert (got.n_features, got.n_classes) == ((20, 6) if kw else (10, 5))
    empty = tmp_path / "header_only.svm"
    empty.write_text("0 30 4\n")
    got = libsvm.read_libsvm(str(empty))
    assert_datasets_equal(got, jlibsvm.read_libsvm(str(empty)))
    assert (got.n_samples, got.n_features, got.n_classes) == (0, 30, 4)
