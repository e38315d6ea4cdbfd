"""The port's ingestion (``repro_torch.core.io`` over the copied
``repro_torch.core.readers``) against the JAX package's: one counterpart of
each ``tests/test_io.py`` case, on ``device="cpu"``, in the same geometry
(N, M, BN, BM = 4096, 256, 512, 128) and under the same tracemalloc bound
(3 x one block row's bytes).

Each streamed load is bit-equal to the port's own ``from_array`` /
``from_scipy`` of the same data, and equal to ``repro``'s loader on the
same file in values, block format, pad state and ``nse``; the spill files
``save_blocks`` writes are the reference's byte for byte, and each package
loads the other's.
"""

import gc
import tracemalloc
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.sparse as ssp  # noqa: E402

import repro.core.io as jio  # noqa: E402
import repro.core.readers as jreaders  # noqa: E402
import repro.core.sparse as jsparse  # noqa: E402
import repro.core as jx  # noqa: E402
import repro.resilience as JR  # noqa: E402
import repro_torch as pt  # noqa: E402
import repro_torch.resilience as R  # noqa: E402
from repro_torch.core import costmodel, readers  # noqa: E402
from repro_torch.core import io as rio  # noqa: E402
from repro_torch.core import sparse as sparse_mod  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

CPU = "cpu"
N, M, BN, BM = 4096, 256, 512, 128
BLOCKROW_BYTES = (M // BM) * BN * BM * 4
ROOT = Path(__file__).resolve().parents[1]


def ds(x, block):
    return pt.from_array(x, block, device=CPU)


def host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _write_txt(path, arr, fmt="%.4e"):
    np.savetxt(path, arr, delimiter=",", fmt=fmt)


def _write_svm(path, mat, one_based=True, label=lambda i: float(i % 3)):
    shift = 1 if one_based else 0
    with open(path, "w") as f:
        for i in range(mat.shape[0]):
            row = mat.getrow(i).tocoo()
            feats = " ".join(f"{c + shift}:{v:.4e}"
                             for c, v in zip(row.col, row.data))
            f.write(f"{label(i)} {feats}\n")


def _svm_oracle_csr(path, n, m):
    """Re-parse a 1-based svmlight file exactly as the loader does."""
    rows, cols, vals, labs = [], [], [], []
    with open(path) as f:
        for i, ln in enumerate(f):
            toks = ln.split()
            labs.append(float(toks[0]))
            for t in toks[1:]:
                c, v = t.split(":")
                rows.append(i)
                cols.append(int(c) - 1)
                vals.append(np.float32(float(v)))
    mat = ssp.coo_matrix((vals, (rows, cols)), shape=(n, m),
                         dtype=np.float32).tocsr()
    return mat, np.asarray(labs, np.float32)


def _tracked_peak(fn):
    """tracemalloc peak of one call, after a warm-up call."""
    fn()
    gc.collect()
    tracemalloc.start()
    out = fn()
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    return peak, out


def _same_dense(got, want):
    """``got`` (port) equals ``want`` (port or reference): format, pad
    state, shape, block shape and the stacked bits."""
    assert got.block_format == want.block_format == "dense"
    assert got.pad_state.kind == want.pad_state.kind
    assert got.shape == tuple(want.shape)
    assert got.block_shape == tuple(want.block_shape)
    assert np.array_equal(host(got.blocks), np.asarray(want.blocks))


def _same_sparse(got, want):
    """Stacked COO equal to a port or reference sparse array: nse, flags,
    pad state and every stored entry (data and block-local indices)."""
    assert got.block_format == want.block_format == "bcoo"
    assert got.pad_state.kind == want.pad_state.kind == "zero"
    assert got.shape == tuple(want.shape)
    assert int(got.blocks.nse) == int(want.blocks.nse)
    assert np.array_equal(host(got.blocks.data), np.asarray(want.blocks.data))
    assert np.array_equal(host(got.blocks.indices),
                          np.asarray(want.blocks.indices))


@pytest.fixture(scope="module")
def big_dense(tmp_path_factory):
    d = tmp_path_factory.mktemp("io_dense")
    rng = np.random.default_rng(0)
    arr = rng.normal(size=(N, M)).astype(np.float32)
    txt = str(d / "big.txt")
    _write_txt(txt, arr)
    npy = str(d / "big.npy")
    np.save(npy, arr)
    return txt, npy, arr


@pytest.fixture(scope="module")
def big_svm(tmp_path_factory):
    d = tmp_path_factory.mktemp("io_svm")
    mat = ssp.random(N, M, density=0.1, random_state=0, format="csr",
                     dtype=np.float32)
    path = str(d / "big.svm")
    _write_svm(path, mat)
    return path


# ---------------------------------------------------------------------------
# byte-range reader (a verbatim copy of the reference's)
# ---------------------------------------------------------------------------


def test_readers_is_the_reference_verbatim():
    ours = (ROOT / "src" / "repro_torch" / "core" / "readers.py").read_text()
    theirs = (ROOT / "src" / "repro" / "core" / "readers.py").read_text()
    assert ours.replace("repro_torch.core.io", "repro.core.io") == theirs


@pytest.mark.parametrize("trailing_nl", [True, False])
@pytest.mark.parametrize("chunk_bytes", [1, 3, 7, 16, 64, 10_000])
def test_chunks_tile_file_exactly(tmp_path, chunk_bytes, trailing_nl):
    rng = np.random.default_rng(int(chunk_bytes) + trailing_nl)
    lines = [bytes(rng.integers(97, 123, size=rng.integers(0, 40),
                                dtype=np.uint8)) for _ in range(50)]
    blob = b"\n".join(lines) + (b"\n" if trailing_nl else b"")
    p = tmp_path / "t.bin"
    p.write_bytes(blob)
    chunks = list(readers.iter_line_chunks(str(p), chunk_bytes))
    assert b"".join(chunks) == blob
    for c in chunks[:-1]:
        assert c.endswith(b"\n")
    assert chunks == list(jreaders.iter_line_chunks(str(p), chunk_bytes))


def test_read_block_line_ownership(tmp_path):
    p = tmp_path / "t.txt"
    p.write_bytes(b"aaaa\nbbbb\ncccc\n")
    with open(p, "rb") as f:
        assert readers.read_block(f, 0, 5) == b"aaaa\n"
        assert readers.read_block(f, 5, 5) == b"bbbb\n"
        assert readers.read_block(f, 6, 2) == b""
        assert readers.read_block(f, 6, 5) == b"cccc\n"
        assert readers.read_block(f, 15, 5) == b""


def test_empty_file_raises(tmp_path):
    p = tmp_path / "empty.txt"
    p.write_bytes(b"")
    assert list(readers.iter_line_chunks(str(p))) == []
    with pytest.raises(ValueError, match="no data"):
        rio.load_txt_file(str(p), (4, 4), device=CPU)


# ---------------------------------------------------------------------------
# streamed loaders == in-memory oracles (bitwise) + O(block-row) host peak
# ---------------------------------------------------------------------------


def test_load_txt_file_bitwise_equal_and_memory_bound(big_dense):
    txt, _, _ = big_dense
    data = np.loadtxt(txt, delimiter=",", dtype=np.float32, ndmin=2)
    oracle = ds(data, (BN, BM))
    peak, got = _tracked_peak(lambda: rio.load_txt_file(txt, (BN, BM),
                                                        device=CPU))
    assert got.shape == (N, M) and got.stacked_grid[0] >= 8
    _same_dense(got, oracle)
    assert peak < costmodel.INGEST_PEAK_FACTOR * BLOCKROW_BYTES, \
        f"peak {peak} >= 3x block-row {BLOCKROW_BYTES}"
    _same_dense(got, jio.load_txt_file(txt, (BN, BM)))


def test_load_svmlight_bitwise_equal_and_memory_bound(big_svm):
    mat, labs = _svm_oracle_csr(big_svm, N, M)
    oracle = sparse_mod.from_scipy(mat, (BN, BM), device=CPU)
    peak, out = _tracked_peak(
        lambda: rio.load_svmlight_file(big_svm, (BN, BM), n_features=M,
                                       device=CPU))
    x, y = out
    _same_sparse(x, oracle)
    assert x.blocks.indices_sorted and x.blocks.unique_indices
    assert y.shape == (N, 1) and y.block_shape == (BN, 1)
    assert np.array_equal(host(y.collect())[:, 0], labs)
    assert peak < costmodel.INGEST_PEAK_FACTOR * BLOCKROW_BYTES, \
        f"peak {peak} >= 3x block-row {BLOCKROW_BYTES}"
    jxs, jys = jio.load_svmlight_file(big_svm, (BN, BM), n_features=M)
    _same_sparse(x, jxs)
    _same_dense(y, jys)


def test_load_svmlight_dense_path_equals_from_array(big_svm):
    mat, labs = _svm_oracle_csr(big_svm, N, M)
    oracle = ds(mat.toarray(), (BN, BM))
    x, y = rio.load_svmlight_file(big_svm, (BN, BM), n_features=M,
                                  store_sparse=False, device=CPU)
    _same_dense(x, oracle)
    assert np.array_equal(host(y.collect())[:, 0], labs)
    jxd, _ = jio.load_svmlight_file(big_svm, (BN, BM), n_features=M,
                                    store_sparse=False)
    _same_dense(x, jxd)


def test_load_npy_rows_streams_off_the_mmap(big_dense):
    _, npy, arr = big_dense
    peak, got = _tracked_peak(lambda: rio.load_npy_rows(npy, (BN, BM),
                                                        device=CPU))
    assert np.array_equal(host(got.collect()), arr)
    assert peak < costmodel.INGEST_PEAK_FACTOR * BLOCKROW_BYTES, \
        f"peak {peak} >= 3x block-row (full file is {arr.nbytes})"
    _same_dense(got, ds(arr, (BN, BM)))
    sub = rio.load_npy_rows(npy, (BN, BM), row_range=(BN, 3 * BN), device=CPU)
    _same_dense(sub, ds(arr[BN:3 * BN], (BN, BM)))
    _same_dense(sub, jio.load_npy_rows(npy, (BN, BM), row_range=(BN, 3 * BN)))
    with pytest.raises(ValueError, match="empty row range"):
        rio.load_npy_rows(npy, (BN, BM), row_range=(BN, BN), device=CPU)
    auto = rio.load_npy_rows(npy, (BN, BM), row_range=(0, BN),
                             block_format="auto", device=CPU)
    assert auto.block_format == "dense"


def test_load_npy_rows_owns_its_memory_and_narrows(tmp_path):
    """Each block row lands in memory torch owns (writing the loaded array
    never reaches the file's buffers), and float64 lands as float32, as
    the reference's loader gives it."""
    arr = np.arange(60, dtype=np.float64).reshape(10, 6)
    p = str(tmp_path / "x64.npy")
    np.save(p, arr)
    got = rio.load_npy_rows(p, (4, 6), device=CPU)
    want = jio.load_npy_rows(p, (4, 6))
    assert got.dtype == torch.float32 and np.asarray(want.blocks).dtype == np.float32
    _same_dense(got, want)
    got.blocks.fill_(-1.0)
    again = rio.load_npy_rows(p, (4, 6), device=CPU)
    assert np.array_equal(host(again.collect()), arr.astype(np.float32))


# ---------------------------------------------------------------------------
# loader edge cases
# ---------------------------------------------------------------------------


def _small_arr():
    return np.arange(70, dtype=np.float32).reshape(10, 7)


def test_txt_crlf_blank_trailing_and_partial_blockrow(tmp_path):
    arr = _small_arr()
    p = tmp_path / "crlf.txt"
    body = b"\r\n".join(b",".join(b"%.3f" % v for v in row) for row in arr)
    p.write_bytes(body + b"\r\n\r\n")
    got = rio.load_txt_file(str(p), (4, 3), chunk_bytes=16, device=CPU)
    assert got.shape == (10, 7)
    _same_dense(got, ds(arr, (4, 3)))
    _same_dense(got, jio.load_txt_file(str(p), (4, 3), chunk_bytes=16))


def test_txt_no_trailing_newline_delimiter_in_last_chunk(tmp_path):
    arr = _small_arr()
    p = tmp_path / "nonl.txt"
    p.write_bytes(b"\n".join(b",".join(b"%.3f" % v for v in row)
                             for row in arr))
    for cb in (7, 16, 33, 1 << 16):
        got = rio.load_txt_file(str(p), (4, 3), chunk_bytes=cb, device=CPU)
        assert np.array_equal(host(got.collect()), arr)


def test_txt_ragged_rows_raise(tmp_path):
    p = tmp_path / "ragged.txt"
    p.write_bytes(b"1.0,2.0\n3.0,4.0,5.0\n")
    with pytest.raises(ValueError):
        rio.load_txt_file(str(p), (2, 2), chunk_bytes=8, device=CPU)


def test_svmlight_one_based_vs_zero_based(tmp_path):
    pz = tmp_path / "zb.svm"
    pz.write_text("1.0 0:2.5 4:1.5\n0.0 2:3.0\n")
    po = tmp_path / "ob.svm"
    po.write_text("1.0 1:2.5 5:1.5\n0.0 3:3.0\n")
    want = np.zeros((2, 5), np.float32)
    want[0, 0], want[0, 4], want[1, 2] = 2.5, 1.5, 3.0
    xz, _ = rio.load_svmlight_file(str(pz), (2, 2), n_features=5,
                                   zero_based=True, device=CPU)
    xo, _ = rio.load_svmlight_file(str(po), (2, 2), n_features=5, device=CPU)
    assert np.array_equal(host(xz.todense().collect()), want)
    assert np.array_equal(host(xo.todense().collect()), want)
    with pytest.raises(ValueError, match="zero_based"):
        rio.load_svmlight_file(str(pz), (2, 2), n_features=5, device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        rio.load_svmlight_file(str(po), (2, 2), n_features=5,
                               zero_based=True, device=CPU)


def test_svmlight_comments_qid_and_blank_lines(tmp_path):
    p = tmp_path / "frills.svm"
    p.write_text("1.0 qid:7 1:2.0 3:4.0 # a comment\n"
                 "\n"
                 "-1.0 2:5.0\n")
    x, y = rio.load_svmlight_file(str(p), (2, 2), n_features=3, device=CPU)
    want = np.array([[2.0, 0.0, 4.0], [0.0, 5.0, 0.0]], np.float32)
    assert np.array_equal(host(x.todense().collect()), want)
    assert np.array_equal(host(y.collect())[:, 0],
                          np.asarray([1.0, -1.0], np.float32))


def test_io_load_fault_mid_stream_leaves_no_partial_state(tmp_path):
    arr = _small_arr()
    p = tmp_path / "fault.txt"
    _write_txt(str(p), arr, fmt="%.3f")
    oracle = ds(np.loadtxt(str(p), delimiter=",", dtype=np.float32, ndmin=2),
                (4, 3))
    with R.inject(R.FaultSpec(kind="io", site="io_load", at=3,
                              where={"source": "load_txt_file"})):
        with pytest.raises(R.IOLoadError):
            rio.load_txt_file(str(p), (4, 3), chunk_bytes=16, device=CPU)
    got = rio.load_txt_file(str(p), (4, 3), chunk_bytes=16, device=CPU)
    _same_dense(got, oracle)


def test_io_load_fault_mid_stream_svmlight(tmp_path):
    mat = ssp.random(12, 6, density=0.4, random_state=3, format="csr",
                     dtype=np.float32)
    p = tmp_path / "fault.svm"
    _write_svm(str(p), mat)
    with R.inject(R.FaultSpec(kind="io", site="io_load", at=3,
                              where={"source": "load_svmlight_file"})):
        with pytest.raises(R.IOLoadError):
            rio.load_svmlight_file(str(p), (4, 3), n_features=6,
                                   chunk_bytes=32, device=CPU)
    x, _ = rio.load_svmlight_file(str(p), (4, 3), n_features=6,
                                  chunk_bytes=32, device=CPU)
    oracle_mat, _ = _svm_oracle_csr(str(p), 12, 6)
    _same_sparse(x, sparse_mod.from_scipy(oracle_mat, (4, 3), device=CPU))


def test_io_load_sites_match_the_reference(tmp_path):
    """Arrival counts per source: the streaming loaders fire on entry and
    per chunk as the reference's do; ``load_npy_rows`` also per block row."""
    arr = _small_arr()
    txt = str(tmp_path / "a.txt")
    _write_txt(txt, arr, fmt="%.3f")
    npy = str(tmp_path / "a.npy")
    np.save(npy, arr)
    with R.inject(R.FaultSpec(kind="io", site="io_load", at=10 ** 9,
                              where={"source": "load_txt_file"})) as (a,):
        rio.load_txt_file(txt, (4, 3), chunk_bytes=16, device=CPU)
    with JR.inject(JR.FaultSpec(kind="io", site="io_load", at=10 ** 9,
                                where={"source": "load_txt_file"})) as (j,):
        jio.load_txt_file(txt, (4, 3), chunk_bytes=16)
    assert a.hits == j.hits > 2
    with R.inject(R.FaultSpec(kind="io", site="io_load", at=10 ** 9,
                              where={"source": "load_npy_rows"})) as (a,):
        rio.load_npy_rows(npy, (4, 3), device=CPU)
    assert a.hits == 1 + 3                       # entry + 3 block rows



# ---------------------------------------------------------------------------
# incremental stacked-COO builder
# ---------------------------------------------------------------------------


def test_builder_fixed_nse_overflow_raises():
    b = sparse_mod.StackedBCOOBuilder(4, (2, 2), nse=1, device=CPU)
    with pytest.raises(ValueError, match="nse=1"):
        b.append_blockrow(np.array([0, 1]), np.array([0, 1]),
                          np.array([1.0, 2.0], np.float32), 2)


def test_builder_column_out_of_range_raises():
    b = sparse_mod.StackedBCOOBuilder(4, (2, 2), device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        b.append_blockrow(np.array([0]), np.array([4]),
                          np.array([1.0], np.float32), 1)


def test_builder_matches_from_scipy_across_row_capacities():
    mat = ssp.random(20, 9, density=0.3, random_state=7, format="csr",
                     dtype=np.float32)
    oracle = sparse_mod.from_scipy(mat, (4, 4), device=CPU)
    b = sparse_mod.StackedBCOOBuilder(9, (4, 4), device=CPU)
    for i in range(0, 20, 4):
        sub = mat[i:i + 4].tocoo()
        b.append_blockrow(sub.row, sub.col, sub.data, min(4, 20 - i))
    got = b.finalize()
    _same_sparse(got, oracle)
    sparse_mod.check_bcoo_invariants(got)
    _same_sparse(got, jsparse.from_scipy(mat, (4, 4)))


# ---------------------------------------------------------------------------
# spill formats: sparse/dense save_blocks / load_blocks, save_npy
# ---------------------------------------------------------------------------


def _dir_bytes(d):
    return {p.name: p.read_bytes() for p in sorted(Path(d).iterdir())}


def test_save_blocks_roundtrips_bcoo(tmp_path):
    mat = ssp.random(20, 9, density=0.3, random_state=11, format="csr",
                     dtype=np.float32)
    a = sparse_mod.from_scipy(mat, (4, 4), device=CPU)
    d = str(tmp_path / "spill")
    rio.save_blocks(d, a)
    back = rio.load_blocks(d, device=CPU)
    assert back.block_format == "bcoo"
    assert back.shape == a.shape and back.block_shape == a.block_shape
    assert back.blocks.indices_sorted and back.blocks.unique_indices
    _same_sparse(back, a)
    # the reference writes the same files, and each package loads the other's
    jd = str(tmp_path / "jspill")
    jio.save_blocks(jd, jsparse.from_scipy(mat, (4, 4)))
    assert _dir_bytes(d) == _dir_bytes(jd)
    _same_sparse(rio.load_blocks(jd, device=CPU), jio.load_blocks(d))


def test_save_blocks_roundtrips_dense(tmp_path):
    arr = np.arange(24, dtype=np.float32).reshape(6, 4)
    a = ds(arr, (2, 2))
    d = str(tmp_path / "spill")
    rio.save_blocks(d, a)
    back = rio.load_blocks(d, device=CPU)
    _same_dense(back, a)
    jd = str(tmp_path / "jspill")
    jio.save_blocks(jd, jx.from_array(jnp.asarray(arr), (2, 2)))
    assert _dir_bytes(d) == _dir_bytes(jd)
    _same_dense(rio.load_blocks(jd, device=CPU), jio.load_blocks(d))


def test_save_npy_raises_on_bcoo(tmp_path):
    mat = ssp.random(8, 4, density=0.5, random_state=1, format="csr",
                     dtype=np.float32)
    a = sparse_mod.from_scipy(mat, (4, 4), device=CPU)
    with pytest.raises(ValueError, match="densify"):
        rio.save_npy(str(tmp_path / "x.npy"), a)
    rio.save_npy(str(tmp_path / "x.npy"), a.todense())
    assert np.array_equal(np.load(str(tmp_path / "x.npy")), mat.toarray())


def test_load_txt_and_from_array_auto_match_the_reference(tmp_path):
    rng = np.random.default_rng(5)
    arr = rng.normal(size=(12, 6)).astype(np.float32)
    arr[rng.random(arr.shape) < 0.8] = 0.0        # sparse enough for auto
    p = str(tmp_path / "a.txt")
    _write_txt(p, arr, fmt="%.5f")
    for fmt in ("dense", "bcoo", "auto"):
        got = rio.load_txt(p, (4, 3), block_format=fmt, device=CPU)
        want = jio.load_txt(p, (4, 3), block_format=fmt)
        assert got.block_format == want.block_format
        if got.block_format == "bcoo":
            _same_sparse(got, want)
        else:
            _same_dense(got, want)
    dense = rng.normal(size=(8, 4)).astype(np.float32)
    assert rio.from_array_auto(dense, (4, 4), device=CPU).block_format == \
        jio.from_array_auto(dense, (4, 4)).block_format == "dense"
    with pytest.raises(ValueError, match="block_format"):
        rio.from_array_auto(dense, (4, 4), block_format="csr", device=CPU)


def test_load_npz_sparse_matches_the_reference(tmp_path):
    mat = ssp.random(30, 11, density=0.25, random_state=2, format="csr",
                     dtype=np.float32)
    p = str(tmp_path / "m.npz")
    ssp.save_npz(p, mat, compressed=False)
    got = rio.load_npz_sparse(p, (8, 4), device=CPU)
    _same_sparse(got, sparse_mod.from_scipy(mat, (8, 4), device=CPU))
    _same_sparse(got, jio.load_npz_sparse(p, (8, 4)))


# ---------------------------------------------------------------------------
# from_scipy explicit-nse guard (the port's)
# ---------------------------------------------------------------------------


def test_from_scipy_nse_overflow_raises():
    mat = ssp.csr_matrix(np.array([[1.0, 2.0], [3.0, 4.0]], np.float32))
    assert sparse_mod.max_block_nnz(mat, (2, 2)) == 4
    with pytest.raises(ValueError, match="nse=2"):
        sparse_mod.from_scipy(mat, (2, 2), nse=2, device=CPU)
    capped = sparse_mod.from_scipy(mat, (2, 2), nse=2, check_nse=False,
                                   device=CPU)
    assert int(capped.blocks.nse) == 2
    ok = sparse_mod.from_scipy(mat, (2, 2), nse=4, device=CPU)
    assert np.array_equal(host(ok.todense().collect()), mat.toarray())


def test_from_scipy_default_nse_never_guards():
    mat = ssp.random(16, 16, density=0.4, random_state=5, format="csr",
                     dtype=np.float32)
    a = sparse_mod.from_scipy(mat, (4, 4), device=CPU)
    assert np.array_equal(host(a.todense().collect()), mat.toarray())


# ---------------------------------------------------------------------------
# costmodel ingest laws (the port's copy)
# ---------------------------------------------------------------------------


def test_ingest_laws_shape():
    row = costmodel.ingest_blockrow_bytes(2, 512, 128, 4)
    assert row == BLOCKROW_BYTES
    streamed = costmodel.ingest_peak_host_bytes(8, 2, 512, 128, 4, 1 << 16)
    full = costmodel.ingest_peak_host_bytes(8, 2, 512, 128, 4, 1 << 16,
                                            streamed=False)
    assert streamed < full == 8 * row
    ratio = costmodel.ingest_peak_ratio(8, 2, 512, 128, 4, 1 << 16)
    assert ratio == pytest.approx(full / streamed)
    assert costmodel.ingest_peak_ratio(16, 2, 512, 128, 4, 1 << 16) > ratio
