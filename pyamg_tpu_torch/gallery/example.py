"""Example-problem loader (counterpart of ``pyamg_tpu/gallery/example.py``).

PyAMG ships ``.mat`` files under ``pyamg/gallery/example_data``.  This
loader searches, in order: ``$PYAMG_TPU_EXAMPLE_DATA``, an
``example_data`` directory next to this file, and an installed ``pyamg``
package's data directory (the JAX package's loader also searches one
fixed directory of its own machine, which is not carried over).
"""

from __future__ import annotations

import os

import numpy as np

_here = os.path.dirname(os.path.abspath(__file__))


def _data_dirs():
    dirs = []
    env = os.environ.get("PYAMG_TPU_EXAMPLE_DATA")
    if env:
        dirs.append(env)
    dirs.append(os.path.join(_here, "example_data"))
    try:
        import pyamg.gallery as _pg
        dirs.append(os.path.join(os.path.dirname(_pg.__file__),
                                 "example_data"))
    except ImportError:
        pass
    return [d for d in dirs if os.path.isdir(d)]


def _examples():
    names = set()
    for d in _data_dirs():
        names.update(f[:-4] for f in os.listdir(d) if f.endswith(".mat"))
    return sorted(names)


def load_example(name, device=True):
    """The example dataset ``name`` (reference ``example.py:14``): a dict
    with 'A' (a host ELL, or scipy CSR with ``device=False``) and any of
    'B', 'vertices', 'elements' and 'docstring' the file holds.  An
    unknown name raises ``ValueError`` listing the available ones."""
    from scipy.io import loadmat
    for d in _data_dirs():
        path = os.path.join(d, name + ".mat")
        if not os.path.isfile(path):
            continue
        data = {}
        for k, v in loadmat(path).items():
            if k.startswith("__"):
                continue
            if k == "A":
                import scipy.sparse as sp
                A = sp.csr_matrix(v)
                if device:
                    from pyamg_tpu_torch.sparse.matrix import from_scipy
                    A = from_scipy(A)
                data["A"] = A
            elif k == "docstring":
                data[k] = str(np.ravel(v)[0]) if np.size(v) else ""
            else:
                data[k] = np.asarray(v)
        return data
    raise ValueError(f"no example matrix named {name!r}; "
                     f"available: {_examples()}")
