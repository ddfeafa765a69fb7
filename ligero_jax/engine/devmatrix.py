"""Device-resident row-chunked matrices.

The prover's bulk matrices (the n-wide codeword matrix U and its
coefficient form) are hundreds of MB to GB at 2^19+ gates.  Downloading
them to the host would put device->host transfers, not math, on the
critical path, so they stay on the device.

``RowChunkedMatrix`` keeps the matrix on the device as a list of
fixed-row-count chunks, each under ``Backend.MAX_DEVICE_BYTES`` (a chunk
size, not a device limit — ROADMAP 3.2); consumers assemble row blocks
or column blocks on the device and only small results (digests, opened
columns, combination polynomials) ever reach the host.

No reference counterpart (the reference is host-resident CPU throughout);
this is the device-resident equivalent of its in-memory U handling
(reference src/ligero/mod.rs:516-551).
"""

from __future__ import annotations


class RowChunkedMatrix:
    """A logical ``(rows, n, L)`` device matrix stored as equal-row chunks.

    ``chunks[i]`` holds rows ``[i*chunk_rows, (i+1)*chunk_rows)``; rows at
    and beyond ``rows`` in the final chunk are exact zeros (padding), so
    including them in sums/NTTs is harmless.
    """

    def __init__(self, chunks: list, rows: int, chunk_rows: int):
        assert chunks, "empty RowChunkedMatrix"
        self.chunks = chunks
        self.rows = rows
        self.chunk_rows = chunk_rows
        self.n = chunks[0].shape[1]
        self.L = chunks[0].shape[2]

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.rows, self.n, self.L)


class StreamedCodewords:
    """A logical ``(rows, n, L)`` canonical codeword matrix that is never
    materialized anywhere — not in HBM, not on the host.

    Holds the (much smaller) device-resident coefficient matrix; consumers
    re-encode row chunks on demand: the streaming commit hashes each chunk
    into per-column incremental Blake2s states
    (``Backend.commit_columns``), and column openings re-encode chunks and
    gather only the ``t`` opened columns (``Backend.gather_columns``).
    This is what lets proof sizes scale past the HBM residency budget
    (k/n = 1/8: the coefficient form is 8x smaller than U).
    """

    def __init__(self, coeffs: "RowChunkedMatrix", n: int, rows: int):
        self.coeffs = coeffs
        self.n = n
        self.rows = rows
        self.L = coeffs.L

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.rows, self.n, self.L)
