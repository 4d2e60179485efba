"""A sparse matrix as padded rows (ELL) in plain PyTorch, so that the
reference computes in any dtype on any device: float64, float32 or
bfloat16, on the CPU or the card.  Imports nothing of the program."""

import numpy as np
import torch


class Ell:
    """Rows of a SciPy CSR matrix as (rows, width) column indices and
    values, padded with column 0 and value 0."""

    def __init__(self, S, device, dtype):
        S = S.tocsr()
        S.sort_indices()
        counts = np.diff(S.indptr)
        width = max(int(counts.max()) if counts.size else 0, 1)
        n = S.shape[0]
        slot = np.arange(S.nnz) - np.repeat(S.indptr[:-1], counts)
        row = np.repeat(np.arange(n), counts)
        cols = np.zeros((n, width), np.int64)
        vals = np.zeros((n, width), np.float64)
        cols[row, slot] = S.indices
        vals[row, slot] = S.data
        self.cols = torch.as_tensor(cols, device=device)
        self.vals = torch.as_tensor(vals, device=device).to(dtype)

    def mv(self, x):
        """A x, each row's products summed in the matrix's dtype."""
        return (self.vals * x[self.cols]).sum(dim=1)

