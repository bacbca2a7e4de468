"""Paged-attention inputs shared by the CPU parity tests and the card tests:
numpy arrays from a seed, in the serving layout ``PagePool.table_array``
produces (tables padded with the trash page, the last physical page)."""
import numpy as np

# (b, sq, h, kv, d, n_pages, page_size, lengths, shuffle): the cases of the
# JAX package's tests/test_paged_attn.py, then serving shapes of
# smollm-360m (H 15, KV 5, D 64, page size 16)
CASES = [
    (3, 1, 4, 2, 16, 4, 8, None, False),           # full pages
    (3, 1, 4, 2, 16, 4, 8, [13, 16, 0], False),    # ragged, boundary, empty
    (2, 12, 4, 2, 16, 3, 8, [24, 9], False),       # q rows past one block
    (3, 4, 4, 2, 16, 4, 8, [17, 32, 5], True),     # shuffled page ids
    (4, 1, 15, 5, 64, 10, 16, [0, 16, 37, 150], True),
    (8, 1, 15, 5, 64, 10, 16, [0, 16, 37, 150, 1, 159, 64, 90], True),
    (2, 4, 15, 5, 64, 10, 16, [31, 0], True),      # causal new keys
]


def problem(b=3, sq=1, h=4, kv=2, d=16, n_pages=4, page_size=8, lengths=None,
            shuffle=False, seed=0, trash_value=None):
    """(q, k_new, v_new, k_pages, v_pages, tables, lengths), float32 and
    int32 numpy.  ``lengths[i]`` cache rows of sequence i are valid; table
    entries past them name the trash page.  ``trash_value`` fills the trash
    page (else it holds random rows like the others)."""
    rng = np.random.default_rng(seed)
    p_total = b * n_pages + 1
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    q, k_new, v_new = f(b, sq, h, d), f(b, sq, kv, d), f(b, sq, kv, d)
    k_pages, v_pages = (f(p_total, page_size, kv, d),
                        f(p_total, page_size, kv, d))
    if trash_value is not None:
        k_pages[-1] = trash_value
        v_pages[-1] = trash_value
    pages = np.arange(b * n_pages)
    if shuffle:
        rng.shuffle(pages)
    tables = pages.reshape(b, n_pages).astype(np.int32)
    if lengths is None:
        lengths = [n_pages * page_size] * b
    lengths = np.asarray(lengths, np.int32)
    for i in range(b):
        tables[i, -(-int(lengths[i]) // page_size):] = p_total - 1
    return q, k_new, v_new, k_pages, v_pages, tables, lengths


def case_kwargs(case):
    b, sq, h, kv, d, n_pages, ps, lengths, shuffle = case
    return dict(b=b, sq=sq, h=h, kv=kv, d=d, n_pages=n_pages, page_size=ps,
                lengths=lengths, shuffle=shuffle)


def case_id(case):
    b, sq, h, kv, d, n_pages, ps, lengths, shuffle = case
    return f"b{b}-sq{sq}-h{h}kv{kv}d{d}-ps{ps}-len{lengths}" + (
        "-shuffled" if shuffle else "")
