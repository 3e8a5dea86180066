"""The port's host-side data tools against the JAX package's: the seeded
host samplers, ``BatchIterator`` and the eight epoch iterators (bit-equal
batches over two epochs for the same seed), the knowledge graph
(``KnowledgeGraph``, ``KGData``), ``ImplicitFeedback``'s remaining views,
``OrderedDefaultDict``/``md5sum``/``typeassert``, and ``Preprocessor``,
whose files must equal JAX's byte for byte."""
import filecmp
import os
import pickle

import numpy as np
import pytest

pytest.importorskip("jax")
import scipy.sparse as sp

from skrx import io as jio
from skrx.io import synthetic as jax_synthetic
from skrx.utils import generic as jgeneric
from skrx.utils import random as jrandom
from skrx_torch import io as tio
from skrx_torch.utils import (OrderedDefaultDict, md5sum, timer, typeassert)
from skrx_torch.utils import random as trandom


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(JAX RSDataset, port RSDataset) over one directory with a .kg file
    holding repeated triplets."""
    root = tmp_path_factory.mktemp("torch_host_io")
    path = jax_synthetic.make_dataset_dir(str(root), num_users=40,
                                          num_items=70, num_ratings=900,
                                          seed=9)
    rng = np.random.default_rng(5)
    trip = np.stack([rng.integers(0, 80, 300), rng.integers(0, 4, 300),
                     rng.integers(0, 80, 300)], axis=1)
    trip = np.concatenate([trip, trip[::7]])
    name = os.path.basename(path)
    with open(os.path.join(path, name + ".kg"), "w") as f:
        f.write("".join(f"{h}\t{r}\t{t}\n" for h, r, t in trip))
    return (jio.RSDataset(path, "\t", "UIRT"),
            tio.RSDataset(path, "\t", "UIRT"))


def _equal(a, b):
    """Bit-equal values of the same dtype and shape, through tuples."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _same_epochs(make_jax, make_torch, seed=3, epochs=2):
    jrandom.set_host_seed(seed)
    trandom.set_host_seed(seed)
    jit, tit = make_jax(), make_torch()
    assert len(jit) == len(tit)
    for _ in range(epochs):
        jb, tb = list(jit), list(tit)
        assert len(jb) == len(tb) == len(tit)
        for x, y in zip(jb, tb):
            _equal(x, y)
    # the two generators are at the same place afterwards
    assert jrandom.host_rng().integers(1 << 30) == \
        trandom.host_rng().integers(1 << 30)


def test_host_samplers_draw_as_jax():
    excl = [3, 5, 5, 9, 0]
    p = np.linspace(1, 2, 20)
    calls = [dict(high=20, size=1), dict(high=20, size=50),
             dict(high=20, size=30, exclusion=excl),
             dict(high=20, size=1, exclusion=excl),
             dict(high=20, size=10, replace=False),
             dict(high=20, size=8, replace=False, exclusion=excl),
             dict(high=20, size=25, p=p),
             dict(high=20, size=12, p=p, exclusion=excl),
             dict(high=6, size=40, exclusion=[0, 1, 2, 3, 4])]
    for seed in (0, 2021):
        jrandom.set_host_seed(seed)
        trandom.set_host_seed(seed)
        for kw in calls:
            _equal(trandom.randint_choice(**kw), jrandom.randint_choice(**kw))
        sizes, excls = [3, 1, 7], [[1, 2], [], [0, 4, 5]]
        for a, b in zip(trandom.batch_randint_choice(10, sizes,
                                                     exclusion=excls),
                        jrandom.batch_randint_choice(10, sizes,
                                                     exclusion=excls)):
            _equal(a, b)
    for bad in (dict(high=0), dict(high=5, size=0),
                dict(high=3, size=2, exclusion=[0, 1, 2])):
        with pytest.raises(ValueError):
            trandom.randint_choice(**bad)
    with pytest.raises(ValueError):
        trandom.batch_randint_choice(5, [1, 2], exclusion=[[0]])


@pytest.mark.parametrize("shuffle,drop_last,batch", [
    (False, False, 7), (True, False, 7), (True, True, 7), (True, True, 64),
    (False, True, 5)])
def test_batch_iterator_equals_jax(shuffle, drop_last, batch):
    a = np.arange(50)
    b = np.arange(100).reshape(50, 2).astype(np.float32)
    for arrays in ((a,), (a, b)):
        _same_epochs(
            lambda: jio.BatchIterator(*arrays, batch_size=batch,
                                      shuffle=shuffle, drop_last=drop_last),
            lambda: tio.BatchIterator(*arrays, batch_size=batch,
                                      shuffle=shuffle, drop_last=drop_last))
    rng_j, rng_t = np.random.default_rng(4), np.random.default_rng(4)
    _same_epochs(lambda: jio.BatchIterator(a, batch_size=8, shuffle=True,
                                           rng=rng_j),
                 lambda: tio.BatchIterator(a, batch_size=8, shuffle=True,
                                           rng=rng_t))
    with pytest.raises(ValueError):
        tio.BatchIterator(a, b[:3])
    with pytest.raises(ValueError):
        tio.BatchIterator(a, batch_size=0)


ITERATORS = [
    ("InteractionIterator", {}),
    ("PointwiseIterator", dict(num_neg=1)),
    ("PointwiseIterator", dict(num_neg=3, drop_last=True)),
    ("PairwiseIterator", dict(num_neg=1)),
    ("PairwiseIterator", dict(num_neg=2, shuffle=False)),
    ("SequentialPointwiseIterator", dict(num_previous=2, num_next=1,
                                         num_neg=2)),
    ("SequentialPointwiseIterator", dict(num_previous=3, num_next=2,
                                         pad=70)),
    ("SequentialPairwiseIterator", dict(num_previous=1, num_next=1)),
    ("SequentialPairwiseIterator", dict(num_previous=2, num_next=2,
                                        pad=70)),
    ("UserVecIterator", {}),
    ("ItemVecIterator", dict(drop_last=True)),
]


@pytest.mark.parametrize("name,kwargs", ITERATORS)
def test_iterators_equal_jax(data, name, kwargs):
    jd, td = data
    _same_epochs(
        lambda: getattr(jio, name)(jd.train_data, batch_size=64, **kwargs),
        lambda: getattr(tio, name)(td.train_data, batch_size=64, **kwargs))


@pytest.mark.parametrize("num_neg", [1, 3])
def test_kg_pairwise_iterator_equals_jax(data, num_neg):
    jd, td = data
    _same_epochs(
        lambda: jio.KGPairwiseIterator(jd.kg_data, num_neg=num_neg,
                                       batch_size=32),
        lambda: tio.KGPairwiseIterator(td.kg_data, num_neg=num_neg,
                                       batch_size=32))


def _same_dicts(a, b):
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], dict):
            assert list(a[k]) == list(b[k])
            for c in a[k]:
                _equal(a[k][c], b[k][c])
        else:
            _equal(a[k], b[k])


def _same_sparse(a, b):
    assert type(a) is type(b) and a.shape == b.shape and a.dtype == b.dtype
    assert (a != b).nnz == 0


def test_knowledge_graph_views_equal_jax(data):
    jd, td = data
    jkg, tkg = jd.kg_data, td.kg_data
    assert (tkg.num_entities, tkg.num_relations, tkg.num_triplets) == \
        (jkg.num_entities, jkg.num_relations, jkg.num_triplets)
    assert tkg.num_triplets < 300 + 43            # repeats dropped
    assert (td.num_entities, td.num_relations, td.num_triplets) == \
        (jd.num_entities, jd.num_relations, jd.num_triplets)
    _equal(tkg.to_triplets(), jkg.to_triplets())
    for view in ("to_head_dict", "to_tail_dict", "to_relation_dict"):
        _same_dicts(getattr(tkg, view)(), getattr(jkg, view)())
    for view in ("to_csr_matrix_dict", "to_coo_matrix_dict"):
        got, ref = getattr(tkg, view)(), getattr(jkg, view)()
        assert list(got) == list(ref)
        for rel in ref:
            _same_sparse(got[rel], ref[rel])
    assert not tkg.is_empty() and len(tkg) == len(jkg)
    empty = tio.KnowledgeGraph(None, 5, 2)
    assert empty.is_empty() and (empty.num_entities, empty.num_relations,
                                 len(empty)) == (5, 2, 0)
    assert "The number of triplets" in td.statistic_info
    with pytest.raises(NotImplementedError):
        td.social_data
    assert tio.SocialNetwork() is not None and tio.SocialData() is not None


def test_kg_file_with_missing_values_warns_as_jax(tmp_path):
    d = tmp_path / "kgnull"
    d.mkdir()
    (d / "kgnull.kg").write_text("0\t1\t2\n0\t1\t2\n3\t\t4\n5\t0\t1\n")
    with pytest.warns(UserWarning, match="null values"):
        tkg = tio.KGData(str(d), "\t").kg_data
    with pytest.warns(UserWarning, match="null values"):
        jkg = jio.KGData(str(d), "\t").kg_data
    assert (tkg.num_entities, tkg.num_relations, tkg.num_triplets) == \
        (jkg.num_entities, jkg.num_relations, jkg.num_triplets) == (6, 2, 3)
    with pytest.raises(FileNotFoundError):
        tio.KGData(str(tmp_path), "\t")


@pytest.mark.parametrize("split", ["train", "test"])
def test_implicit_feedback_views_equal_jax(data, split):
    jd, td = data
    jf, tf = getattr(jd, split + "_data"), getattr(td, split + "_data")
    assert tf.is_empty() is jf.is_empty() is False
    assert tf.to_set_of_users() == jf.to_set_of_users()
    _same_dicts(tf.to_item_dict(), jf.to_item_dict())
    _same_sparse(tf.to_csc_matrix(), jf.to_csc_matrix())
    _same_sparse(tf.to_dok_matrix().tocsr(), jf.to_dok_matrix().tocsr())
    assert isinstance(tf.to_dok_matrix(), sp.dok_matrix)
    assert tio.ImplicitFeedback(None, 3, 4).is_empty()
    assert td.valid_data.is_empty() == jd.valid_data.is_empty()


def test_generic_helpers_equal_jax(tmp_path, capsys):
    d = OrderedDefaultDict(list)
    jdd = jgeneric.OrderedDefaultDict(list)
    for k, v in ((3, "a"), (1, "b"), (3, "c")):
        d[k].append(v)
        jdd[k].append(v)
    assert list(d.items()) == list(jdd.items()) == [(3, ["a", "c"]),
                                                    (1, ["b"])]
    assert list(pickle.loads(pickle.dumps(d)).items()) == list(d.items())
    with pytest.raises(TypeError):
        OrderedDefaultDict(3)
    with pytest.raises(KeyError):
        OrderedDefaultDict()["x"]
    f = tmp_path / "blob"
    f.write_bytes(os.urandom(3000))
    assert md5sum(str(f), chunk_size=1000) == jgeneric.md5sum(str(f))

    @typeassert(x=int, y=(int, float))
    def add(x, y=1.0):
        return x + y
    assert add(1, 2) == 3 and add(1) == 2.0
    with pytest.raises(TypeError):
        add(1.5, 2)
    with pytest.raises(TypeError):
        add(1, "2")

    @timer
    def twice(x):
        return 2 * x
    assert twice(4) == 8
    assert "twice took" in capsys.readouterr().out


def _raw_file(tmp_path, columns):
    """A raw log with non-contiguous ids, repeated rows, float and int
    ratings and a row with a missing field."""
    rng = np.random.default_rng(12)
    n = 500
    u = rng.integers(0, 35, n) * 7 + 100
    i = rng.integers(0, 60, n)
    r = rng.integers(1, 6, n).astype(float)
    r[::9] += 0.5
    t = rng.integers(10_000, 10_200, n)
    cols = {"UI": (u, i), "UIRT": (u, i, r, t)}[columns]
    lines = ["\t".join(str(c[k]) for c in cols) for k in range(n)]
    lines += lines[40:70]                        # repeated rows
    lines[11] = "\t".join(["107", ""] + (["3", "10001"] if columns == "UIRT"
                                         else []))
    path = tmp_path / f"rawlog_{columns}.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("columns", ["UI", "UIRT"])
@pytest.mark.parametrize("split,by_time", [
    ("ratio", True), ("ratio", False), ("leave", True), ("leave", False)])
def test_preprocessor_files_equal_jax_byte_for_byte(tmp_path, columns,
                                                    split, by_time):
    src = _raw_file(tmp_path, columns)
    out = {}
    for tag, cls in (("jax", jio.Preprocessor), ("torch", tio.Preprocessor)):
        p = cls()
        p.load_data(src, sep="\t", columns=columns)
        p.drop_duplicates(keep="first" if by_time else "last")
        p.filter_data(user_min=5, item_min=3)
        p.remap_data_id()
        np.random.seed(31)
        if split == "ratio":
            p.split_data_by_ratio(0.7, 0.1, 0.2, by_time=by_time)
        else:
            p.split_data_by_leave_out(valid=1, test=1, by_time=by_time)
        out[tag] = p.save_data(str(tmp_path / tag))
    names = sorted(os.listdir(out["jax"]))
    assert names == sorted(os.listdir(out["torch"]))
    assert {os.path.splitext(n)[1] for n in names} == {
        ".all", ".train", ".valid", ".test", ".user2id", ".item2id", ".info"}
    for name in names:
        assert filecmp.cmp(os.path.join(out["jax"], name),
                           os.path.join(out["torch"], name),
                           shallow=False), name


def test_preprocessor_string_ids_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    lines = [f"u{a}\tit{b}\t{c}\t{d}" for a, b, c, d in zip(
        rng.integers(0, 20, 300), rng.integers(0, 30, 300),
        rng.integers(1, 6, 300), rng.integers(0, 50, 300))]
    lines[3] = "u1\tit2\tNA\t5"
    src = tmp_path / "strs.csv"
    src.write_text("\n".join(lines) + "\n")
    out = {}
    for tag, cls in (("jax", jio.Preprocessor), ("torch", tio.Preprocessor)):
        p = cls()
        p.load_data(str(src), sep="\t", columns="UIRT")
        p.drop_duplicates()
        p.filter_data(2, 2)
        p.remap_data_id()
        np.random.seed(1)
        p.split_data_by_ratio(0.6, 0.2, 0.2, by_time=False)
        out[tag] = p.save_data(str(tmp_path / tag))
    names = sorted(os.listdir(out["jax"]))
    assert len(names) == 7
    for name in names:
        assert filecmp.cmp(os.path.join(out["jax"], name),
                           os.path.join(out["torch"], name),
                           shallow=False), name


def test_preprocessor_without_valid_and_from_arrays_equals_jax(tmp_path):
    import pandas as pd
    rng = np.random.default_rng(2)
    cols = {"user": rng.integers(0, 20, 300), "item": rng.integers(0, 30, 300),
            "rating": rng.integers(1, 6, 300),
            "time": rng.integers(0, 100, 300)}
    jp, tp = jio.Preprocessor(), tio.Preprocessor()
    jp.load_dataframe(pd.DataFrame(cols), columns="UIRT", name="arr",
                      dir_path=str(tmp_path))
    tp.load_arrays(cols, columns="UIRT", name="arr", dir_path=str(tmp_path))
    for p, tag in ((jp, "jax"), (tp, "torch")):
        p.drop_duplicates()
        p.filter_data(user_min=2)
        p.remap_data_id()
        p.split_data_by_ratio(0.8, 0.0, 0.2, by_time=True)
        out = p.save_data(str(tmp_path / tag))
    assert p.valid_data is None
    names = sorted(os.listdir(out))
    assert not any(n.endswith(".valid") for n in names)
    for name in names:
        assert filecmp.cmp(os.path.join(tmp_path, "jax", os.path.basename(out),
                                        name), os.path.join(out, name),
                           shallow=False), name
    with pytest.raises(ValueError):
        tp.split_data_by_ratio(0.5, 0.1, 0.1)
    with pytest.raises(ValueError):
        tp.split_data_by_ratio(0.0, 0.5, 0.5)
    with pytest.raises(ValueError):
        tp.drop_duplicates(keep="middle")
    with pytest.raises(FileNotFoundError):
        tp.load_data(str(tmp_path / "none.csv"), columns="UI")
    with pytest.raises(ValueError):
        tp.load_data(__file__, columns="UX")
