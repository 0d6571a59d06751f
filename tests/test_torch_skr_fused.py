"""SKR's fused entry (``kernels.skr_rectify.skr_process_batched``: the queue
pass and Eq. 31 in one launch on the card) as far as the CPU can check it.

Its plain version (``ref.skr_process_batched_ref``, the path a CPU tensor
takes) and ``core.skr.skr_process_batch`` are held to the JAX package's
``repro.core.skr.skr_process_batch`` (a ``lax.scan``): count, head and q
exact (q only ever stores copies of p_c); Q within 1e-6 (the queue mean is
an fp32 sum of up to Bq values taken in another order).

A numpy emulation of the CUDA kernel's phases (``csrc/skr_rectify.cu``:
the per-row argmax by 32 lanes and a butterfly, class threads walking the
rows in order, slot-order queue sums, chunks of rows) is held to the same
reference. It lives here and is never on the port's path; on the card the
kernel itself is held to the plain version (``tests/test_torch_gpu.py``,
``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import skr as J
from repro_torch.core import skr as T
from repro_torch.kernels import _lib, ops
from repro_torch.kernels import skr_rectify as skr
from repro_torch.kernels.skr_rectify import skr_process_batched, skr_process_rows

KCHUNK = 1024  # csrc/skr_rectify.cu kChunk


def _state(B, C, Bq, rng, kind):
    """Queue states of one kind: 'mixed' (partly filled, heads anywhere),
    'full' (every count at Bq, heads wrapped), 'empty'."""
    q = rng.uniform(0.2, 0.95, (B, C, Bq)).astype(np.float32)
    if kind == "empty":
        return np.zeros_like(q), np.zeros((B, C), np.int32), np.zeros((B, C), np.int32)
    if kind == "full":
        count = np.full((B, C), Bq, np.int32)
    else:
        count = rng.integers(0, Bq + 1, (B, C)).astype(np.int32)
    head = rng.integers(0, Bq, (B, C)).astype(np.int32)
    return q, count, head


def _probs(B, N, C, rng, classes=3, ties=False):
    """Labels drawn from a few classes (so they repeat and later rows see
    earlier pushes), about half the rows correctly attributed; with
    ``ties`` every other row has its maximum on two classes, one the label."""
    labels = rng.integers(0, min(classes, C), (B, N))
    logits = rng.standard_normal((B, N, C)) * 2.0
    boost = rng.random((B, N)) < 0.5
    bi, ni = np.nonzero(boost)
    logits[bi, ni, labels[bi, ni]] += 6.0
    p = np.exp(logits / 0.5)
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    if ties and C > 1:
        for b in range(B):
            for i in range(0, N, 2):
                y = labels[b, i]
                other = (y + 1) % C if i % 4 else (y - 1) % C  # below or above the label
                p[b, i] = 0.5 / C
                p[b, i, y] = p[b, i, other] = 0.25
    return p, labels


def _jax(p, labels, q, count, head):
    """The reference, one call per pair."""
    out = []
    for b in range(p.shape[0]):
        st = {"q": jnp.asarray(q[b]), "count": jnp.asarray(count[b]),
              "head": jnp.asarray(head[b])}
        new, Q = J.skr_process_batch(st, jnp.asarray(p[b]), jnp.asarray(labels[b]))
        out.append((np.asarray(Q), np.asarray(new["q"]), np.asarray(new["count"]),
                    np.asarray(new["head"])))
    return tuple(np.stack(x) for x in zip(*out))


def _held(got, want):
    gQ, gq, gc, gh = (np.asarray(x) for x in got)
    wQ, wq, wc, wh = want
    assert np.array_equal(gc, wc) and np.array_equal(gh, wh)
    assert np.array_equal(gq, wq)
    np.testing.assert_allclose(gQ, wQ, rtol=0, atol=1e-6)


CASES = [  # B, N, C, Bq, state kind, labels from how many classes, ties
    (1, 8, 10, 20, "mixed", 3, False),   # FedEEC's teacher step
    (1, 8, 10, 20, "empty", 3, False),
    (1, 24, 10, 4, "full", 2, False),    # pushes wrap the heads again and again
    (1, 16, 10, 3, "mixed", 1, True),    # one class, argmax ties
    (3, 8, 10, 20, "mixed", 3, True),
    (3, 12, 5, 3, "full", 5, False),
    (2, 30, 7, 5, "empty", 2, True),
    (3, 1, 4, 1, "mixed", 4, False),     # one slot a queue
    (2, 20, 12, 6, "mixed", 12, True),   # labels from every class
]


@pytest.mark.parametrize("B,N,C,Bq,kind,classes,ties", CASES)
def test_plain_version_matches_the_scan(B, N, C, Bq, kind, classes, ties):
    rng = np.random.default_rng(B * 1000 + N * 10 + Bq)
    q, count, head = _state(B, C, Bq, rng, kind)
    p, labels = _probs(B, N, C, rng, classes, ties)
    want = _jax(p, labels.astype(np.int32), q, count, head)
    before = [a.copy() for a in (q, count, head)]
    for dtype in (torch.int64, torch.int32):
        got = skr_process_batched(torch.from_numpy(p), torch.from_numpy(labels).to(dtype),
                                  *(torch.from_numpy(a) for a in (q, count, head)))
        _held(got, want)
    # the input state is not written
    assert all(np.array_equal(a, b) for a, b in zip((q, count, head), before))


@pytest.mark.parametrize("B,N,C,Bq,kind,classes,ties", CASES)
def test_core_skr_process_batch_matches_the_scan(B, N, C, Bq, kind, classes, ties):
    """``core.skr.skr_process_batch`` (one pair a call) through the new
    entry; B pairs are B calls, each held to its own JAX call."""
    rng = np.random.default_rng(B * 1000 + N * 10 + Bq)
    q, count, head = _state(B, C, Bq, rng, kind)
    p, labels = _probs(B, N, C, rng, classes, ties)
    want = _jax(p, labels.astype(np.int32), q, count, head)
    got = []
    for b in range(B):
        st = {"q": torch.from_numpy(q[b]), "count": torch.from_numpy(count[b]),
              "head": torch.from_numpy(head[b])}
        new, Q = T.skr_process_batch(st, torch.from_numpy(p[b]), torch.from_numpy(labels[b]))
        got.append((Q, new["q"], new["count"], new["head"]))
    _held(tuple(torch.stack(x) for x in zip(*got)), want)


def test_one_pair_entry_is_the_batched_entrys_slice():
    rng = np.random.default_rng(7)
    q, count, head = _state(1, 10, 20, rng, "mixed")
    p, labels = _probs(1, 8, 10, rng)
    a = skr_process_rows(*(torch.from_numpy(x[0]) for x in (p, labels, q, count, head)))
    b = skr_process_batched(*(torch.from_numpy(x) for x in (p, labels, q, count, head)))
    assert all(torch.equal(x, y[0]) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(a, ops.skr_process(
        *(torch.from_numpy(x[0]) for x in (p, labels, q, count, head)))))


def test_a_tie_on_the_label_is_misattributed_below_and_correct_above():
    """argmax takes the lowest index of equal maxima: a label that ties a
    lower class is rectified, one that ties a higher class is pushed."""
    p = torch.tensor([[0.4, 0.4, 0.2], [0.4, 0.4, 0.2]])
    labels = torch.tensor([1, 0])
    q = torch.tensor([[0.9, 0.0], [0.8, 0.0], [0.0, 0.0]])
    count = torch.tensor([1, 1, 0], dtype=torch.int32)
    head = torch.tensor([1, 1, 0], dtype=torch.int32)
    Q, nq, nc, nh = skr_process_rows(p, labels, q, count, head)
    scale = (1 - q[1, 0]) / (1 - p[0, 1])  # fp32, Eq. 31 with q̄ = 0.8
    assert torch.equal(Q[0], torch.stack([p[0, 0] * scale, q[1, 0], p[0, 2] * scale]))
    assert torch.equal(Q[1], p[1])
    assert nc.tolist() == [2, 1, 0] and nh.tolist() == [0, 1, 0] and nq[0, 1] == 0.4


def test_wrapper_rejects_bad_inputs():
    p = torch.full((1, 4, 10), 0.1)
    y = torch.zeros(1, 4, dtype=torch.int64)
    q = torch.zeros(1, 10, 3)
    c = torch.zeros(1, 10, dtype=torch.int32)
    with pytest.raises(TypeError):
        skr_process_batched(p.double(), y, q, c, c)
    with pytest.raises(TypeError):
        skr_process_batched(p, y, q, c.long(), c)
    with pytest.raises(TypeError):
        skr_process_batched(p, y.float(), q, c, c)
    with pytest.raises(ValueError):
        skr_process_batched(p, y[:, :3], q, c, c)
    with pytest.raises(ValueError):
        skr_process_batched(p, y, q[:, :9], c, c)
    with pytest.raises(ValueError):
        skr_process_batched(p, y, q[..., :0], c, c)
    with pytest.raises(ValueError):
        skr_process_batched(p[0], y[0], q[0], c[0], c[0])


def test_fault_words_raise_once_at_the_next_check(monkeypatch):
    """``_lib.check_faults``, which ``_lib.check_labels`` calls after its
    sync on the card: a set word raises its kernel's error once and is
    zeroed; another device's words wait for that device's check."""
    words, other = np.zeros(4, np.int32), np.zeros(4, np.int32)
    monkeypatch.setattr(_lib, "_faults", {("skr_process", 0): (words, None, skr._fault),
                                          ("skr_process", 1): (other, None, skr._fault)})
    dev = torch.device("cuda", 0)
    _lib.check_faults(dev)
    words[2], other[0] = 1, 2
    with pytest.raises(ValueError, match="label"):
        _lib.check_faults(dev)
    assert not words.any() and other.tolist() == [2, 0, 0, 0]
    _lib.check_faults(dev)
    words[1] = 2
    with pytest.raises(ValueError, match="count"):
        _lib.check_faults(dev)
    with pytest.raises(ValueError, match="head"):
        _lib.check_faults(torch.device("cuda", 1))
    _lib.check_faults(torch.device("cuda", 1))


def test_cpu_path_counts_no_launch():
    ops.reset_launches()
    rng = np.random.default_rng(3)
    q, count, head = _state(2, 10, 20, rng, "mixed")
    p, labels = _probs(2, 8, 10, rng)
    skr_process_batched(*(torch.from_numpy(x) for x in (p, labels, q, count, head)))
    assert all(v == 0 for v in ops.launches.values())


# --- the kernel's phases, emulated -------------------------------------------


def _above(a, b):
    """csrc/skr_rectify.cu above(): larger, or NaN against a number."""
    return a > b or (np.isnan(a) and not np.isnan(b))


def _warp_argmax(row):
    """Phase 1's argmax: each lane keeps the first maximum of the elements it
    reads (j % 32 == lane), then a butterfly over offsets 16..1 merges lanes
    with the kernel's rule."""
    best, arg = [np.float32(0)] * 32, [-1] * 32
    for j, v in enumerate(row):
        lane = j % 32
        if arg[lane] < 0 or _above(v, best[lane]):
            best[lane], arg[lane] = v, j
    for off in (16, 8, 4, 2, 1):
        pb, pa = list(best), list(arg)
        for lane in range(32):
            ob, oa = pb[lane ^ off], pa[lane ^ off]
            b, a = pb[lane], pa[lane]
            if oa >= 0 and (a < 0 or _above(ob, b) or (not _above(b, ob) and oa < a)):
                best[lane], arg[lane] = ob, oa
    assert len(set(arg)) == 1  # every lane ends with the same pick
    return arg[0]


def _kernel_emulation(p, labels, q, count, head, chunk=KCHUNK):
    """The fused kernel's phases in numpy fp32, chunk by chunk: (Q, q,
    count, head, err)."""
    B, N, C = p.shape
    Bq = q.shape[2]
    f32 = np.float32
    Q = np.empty_like(p)
    q, count, head = q.copy(), count.copy(), head.copy()
    err = np.zeros(B, np.int32)
    for b in range(B):
        for r0 in range(0, N, chunk):
            rows = range(r0, min(N, r0 + chunk))
            lab, pc, correct, rect, qb = {}, {}, {}, {}, {}
            for i in rows:  # phase 1
                y = int(labels[b, i])
                ok = 0 <= y < C
                lab[i] = y if ok else -1
                pc[i] = p[b, i, y] if ok else f32(0)
                correct[i] = ok and _warp_argmax(p[b, i]) == y
                rect[i] = False
                err[b] |= 0 if ok else 1
            for c in range(C):  # phase 2: classes are independent
                cnt, hd = int(count[b, c]), int(head[b, c])
                if not (0 <= cnt <= Bq and 0 <= hd < Bq):
                    err[b] |= 2
                    continue
                for i in rows:
                    if lab[i] != c:
                        continue
                    s = f32(0)
                    for k in range(cnt):
                        s = f32(s + q[b, c, k])
                    qb[i] = f32(s / f32(max(cnt, 1)))
                    if correct[i]:
                        q[b, c, hd] = pc[i]
                        hd = 0 if hd + 1 == Bq else hd + 1
                        cnt = min(cnt + 1, Bq)
                    elif cnt > 0:
                        rect[i] = True
                count[b, c], head[b, c] = cnt, hd
            for i in rows:  # phase 3
                row = p[b, i]
                if rect[i]:
                    scale = f32((f32(1) - qb[i]) / max(f32(1) - pc[i], f32(1e-12)))
                    Q[b, i] = np.where(np.arange(C) == lab[i], qb[i], row * scale)
                else:
                    Q[b, i] = row
    return Q, q, count, head, err


@pytest.mark.parametrize("C", [1, 2, 3, 4, 10, 31, 32, 33, 64, 100, 1024])
def test_warp_argmax_is_torch_argmax(C):
    """The butterfly's pick is the first maximum, NaN counting as the
    largest value, as torch.argmax and jnp.argmax give it."""
    rng = np.random.default_rng(C)
    rows = [rng.random(C).astype(np.float32) for _ in range(20)]
    rows += [np.round(rng.random(C) * 3).astype(np.float32) for _ in range(20)]  # ties
    rows += [np.zeros(C, np.float32), np.full(C, -np.inf, np.float32)]
    for k in range(3):
        r = rng.random(C).astype(np.float32)
        r[rng.integers(0, C, k + 1)] = np.nan
        rows.append(r)
    for r in rows:
        assert _warp_argmax(r) == int(torch.argmax(torch.from_numpy(r)))
        assert _warp_argmax(r) == int(jnp.argmax(jnp.asarray(r)))


@pytest.mark.parametrize("B,N,C,Bq,kind,classes,ties", CASES)
@pytest.mark.parametrize("chunk", [KCHUNK, 5])
def test_kernel_emulation_matches_the_scan(B, N, C, Bq, kind, classes, ties, chunk):
    """Rows in chunks of 5 as well: the class threads carry their queues
    from one chunk to the next."""
    rng = np.random.default_rng(B * 1000 + N * 10 + Bq)
    q, count, head = _state(B, C, Bq, rng, kind)
    p, labels = _probs(B, N, C, rng, classes, ties)
    want = _jax(p, labels.astype(np.int32), q, count, head)
    *got, err = _kernel_emulation(p, labels, q, count, head, chunk)
    _held(got, want)
    assert not err.any()


def test_kernel_emulation_flags_bad_labels_and_state():
    rng = np.random.default_rng(11)
    q, count, head = _state(3, 10, 4, rng, "mixed")
    p, labels = _probs(3, 6, 10, rng)
    labels[0, 2] = 10
    labels[1, 0] = -1
    head[2, 4] = 4
    Q, _, _, _, err = _kernel_emulation(p, labels, q, count, head)
    assert err.tolist() == [1, 1, 2]  # a class's state is checked whether or not its rows come
    assert np.array_equal(Q[0, 2], p[0, 2]) and np.array_equal(Q[1, 0], p[1, 0])
