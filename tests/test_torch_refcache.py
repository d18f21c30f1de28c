"""A cache of tpureg's reference results, computed once a test session and
shared by the pytest-xdist workers, and its tests.

Under ``--dist load`` the tests of one module go to every worker, and each
worker that draws one sets the module's fixtures up again: tpureg's fp64
train steps, which take minutes to compile beside five other workers, ran
up to six times a session. The session fixture ``refcache`` gives
``refcache(name, compute)``, which runs ``compute()`` in the first worker
that asks, under a file lock, and stores the result under the session's
temporary root: the structure as a pickle, each numpy array of 64 KiB or
more as an ``.npy`` file of its own, which every worker maps copy-on-write
(so the page cache holds one copy of FlowNet2's snapshots, not one a
worker, and a caller's writes stay its own); JAX arrays are stored as
numpy arrays.

The cache holds gigabytes (FlowNet2's initialisation, three snapshots and
two Adam states: 5.2 GB). Each worker that uses it is registered; the last
to finish its session deletes the entries. When this session stores its
first entry, the directories of the earlier sessions that have finished
are deleted whole (pytest keeps the last three, and tpureg's CLI tests
leave 3.8 GB in each): a session whose own files and cache peak at about
12 GB ran out of disk behind two of them (``Not enough free space to
write`` while storing FlowNet2's entry; every test of the module failed in
setup). A session that is still running (pytest's ``.lock`` in its
directory) is left alone.
"""

import os
import pickle
import re
import shutil
import time
import uuid

import jax
import numpy as np
import pytest
from filelock import FileLock

_BIG = 1 << 16
_SESSION_DIR = re.compile(r"pytest-\d+")


def _cache_root(tmp_path_factory):
    """``refcache/`` in the session's root: the directory above the worker's
    base temp under xdist (shared by the workers of this session only), the
    base temp itself without xdist."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    return base / "refcache"


class _Pickler(pickle.Pickler):
    """Big numpy arrays to ``.npy`` files; JAX arrays stored as numpy."""

    def __init__(self, f, folder):
        super().__init__(f, protocol=pickle.HIGHEST_PROTOCOL)
        self.folder, self.n = folder, 0

    def reducer_override(self, obj):
        if isinstance(obj, jax.Array):
            return np.asarray, (np.asarray(obj),)
        return NotImplemented

    def persistent_id(self, obj):
        if (type(obj) is np.ndarray and obj.nbytes >= _BIG
                and not obj.dtype.hasobject):
            name = f"{self.n}.npy"
            self.n += 1
            np.save(self.folder / name, obj)
            return name
        return None


class _Unpickler(pickle.Unpickler):
    def __init__(self, f, folder):
        super().__init__(f)
        self.folder = folder

    def persistent_load(self, pid):
        return np.load(self.folder / pid, mmap_mode="c")


class _Cache:
    def __init__(self, root):
        self.root = root

    def __call__(self, name, compute):
        """``compute()`` once a session; every caller gets the stored
        result."""
        folder = self.root / name
        with FileLock(str(self.root / f"{name}.lock")):
            if not (folder / "done").exists():
                if not any(self.root.glob("*/done")):
                    _remove_finished_sessions(self.root)
                shutil.rmtree(folder, ignore_errors=True)
                folder.mkdir()
                value = compute()
                with open(folder / "tree.pkl", "wb") as f:
                    _Pickler(f, folder).dump(value)
                (folder / "done").write_text(str(time.time()))
            with open(folder / "tree.pkl", "rb") as f:
                return _Unpickler(f, folder).load()


def _remove_finished_sessions(root):
    """Delete the directories of earlier sessions beside this one's, pytest's
    numbered ``pytest-<n>``, that have finished: pytest removes a session's
    ``.lock`` when the session ends. This session's directory and pytest's
    ``pytest-current`` link to it are left alone, and nothing is deleted
    where the session's directory is not a numbered one (``--basetemp``)."""
    here = root.parent
    if not _SESSION_DIR.fullmatch(here.name):
        return
    for other in here.parent.iterdir():
        if (_SESSION_DIR.fullmatch(other.name) and other.name != here.name
                and not other.is_symlink() and other.is_dir()
                and not (other / ".lock").exists()):
            shutil.rmtree(other, ignore_errors=True)


def _registered(root, worker):
    """Yield the cache under ``root`` with ``worker`` registered as a user;
    on resuming, unregister it and, if it was the last, delete the
    entries. (Each module that imports the fixture holds a session fixture
    of its own, so a worker may register more than once.)"""
    users = root / "users"
    users.mkdir(parents=True, exist_ok=True)
    me = users / f"{worker}-{uuid.uuid4().hex}"
    lock = FileLock(str(root / "users.lock"))
    with lock:
        me.touch()
    yield _Cache(root)
    with lock:
        me.unlink()
        if not any(users.iterdir()):
            for entry in root.iterdir():
                if entry.is_dir() and entry != users:
                    shutil.rmtree(entry, ignore_errors=True)


@pytest.fixture(scope="session")
def refcache(tmp_path_factory):
    """``refcache(name, compute)``: ``compute()``'s result, computed once a
    session (the module docstring)."""
    yield from _registered(_cache_root(tmp_path_factory),
                           os.environ.get("PYTEST_XDIST_WORKER", "main"))


def test_computes_once_and_shares_the_result(refcache):
    calls = []

    def compute():
        calls.append(1)
        return {"big": np.arange(_BIG, dtype=np.float64), "small": np.ones(3),
                "nested": [{"x": 1.5}, ("a", np.float32(2.0))],
                "jax": jax.numpy.arange(4.0)}

    name = f"selftest-{os.getpid()}"
    first = refcache(name, compute)
    again = refcache(name, compute)
    first["big"][0] = -1.0  # a caller's write stays its own
    for got in (again, refcache(name, compute)):
        assert isinstance(got["big"], np.memmap)
        assert np.array_equal(got["big"], np.arange(_BIG, dtype=np.float64))
        assert type(got["small"]) is np.ndarray and got["small"].tolist() == [1.0] * 3
        assert got["nested"] == [{"x": 1.5}, ("a", np.float32(2.0))]
        assert type(got["jax"]) is np.ndarray and got["jax"].tolist() == [0, 1, 2, 3]
    assert calls == [1]


def test_a_failed_compute_leaves_no_entry(refcache):
    name = f"selftest-fail-{os.getpid()}"

    def fail():
        raise RuntimeError("no result")

    with pytest.raises(RuntimeError, match="no result"):
        refcache(name, fail)
    assert refcache(name, lambda: 7) == 7


def test_the_last_user_deletes_the_entries(tmp_path):
    """Two users of one cache: the entries outlive the first and go with
    the second; an earlier session's directory, its cache and its other
    files, goes with the first entry."""
    old = tmp_path / "pytest-1" / "refcache" / "entry"
    old.mkdir(parents=True)
    (tmp_path / "pytest-1" / "popen-gw2" / "test_train_cli0").mkdir(parents=True)
    root = tmp_path / "pytest-2" / "refcache"
    root.mkdir(parents=True)
    (tmp_path / "pytest-current").symlink_to(root.parent)
    users = [_registered(root, w) for w in ("gw0", "gw1")]
    caches = [next(u) for u in users]
    assert caches[0]("entry", lambda: np.ones(_BIG)).sum() == _BIG
    assert not (tmp_path / "pytest-1").exists()
    assert (tmp_path / "pytest-current").resolve() == root.parent
    assert caches[1]("entry", lambda: None).sum() == _BIG
    for i, user in enumerate(users):
        with pytest.raises(StopIteration):
            next(user)
        assert (root / "entry" / "done").exists() == (i == 0)


def test_a_running_session_keeps_its_directory(tmp_path):
    """The first entry deletes finished sessions only: a directory holding
    pytest's ``.lock`` belongs to a session still running, and keeps its
    cache and its files."""
    running = tmp_path / "pytest-3"
    (running / "refcache" / "entry").mkdir(parents=True)
    (running / ".lock").write_text("4242")
    finished = tmp_path / "pytest-4" / "popen-gw0"
    finished.mkdir(parents=True)
    root = tmp_path / "pytest-5" / "refcache"
    root.mkdir(parents=True)
    user = _registered(root, "gw0")
    cache = next(user)
    assert cache("entry", lambda: 3) == 3
    assert (running / "refcache" / "entry").is_dir()
    assert not finished.parent.exists()
    with pytest.raises(StopIteration):
        next(user)


def test_no_session_directory_is_deleted_under_basetemp(tmp_path):
    """Under ``--basetemp`` the session's directory is not pytest's
    numbered one: nothing beside it is deleted."""
    beside = tmp_path / "pytest-7" / "popen-gw0"
    beside.mkdir(parents=True)
    root = tmp_path / "mine" / "refcache"
    root.mkdir(parents=True)
    user = _registered(root, "gw0")
    assert next(user)("entry", lambda: 1) == 1
    assert beside.is_dir()
    with pytest.raises(StopIteration):
        next(user)
