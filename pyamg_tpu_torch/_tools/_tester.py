"""A numpy-style pytest runner for the port's own tests.

Usage::

    import pyamg_tpu_torch
    pyamg_tpu_torch.test()                # tests/test_torch_*.py
    pyamg_tpu_torch.test("-k halo")       # with extra pytest arguments
"""

from __future__ import annotations

import glob
import os
import sys


class PytestTester:
    """Calls pytest on the port's test files, ``tests/test_torch_*.py``
    beside the package (the JAX package's tests are not the port's and
    are not run).  Returns whether every test passed."""

    def __init__(self, module_name):
        self.module_name = module_name

    def files(self):
        """The port's test files, sorted."""
        pkg_dir = os.path.dirname(
            os.path.abspath(sys.modules[self.module_name].__file__))
        tests_dir = os.path.join(os.path.dirname(pkg_dir), "tests")
        return sorted(glob.glob(os.path.join(tests_dir, "test_torch_*.py")))

    def __call__(self, extra_argv=None, verbose=False):
        import pytest
        files = self.files()
        if not files:
            raise FileNotFoundError("the port's tests/test_torch_*.py are "
                                    "not beside the package")
        args = ["-v" if verbose else "-q"]
        if isinstance(extra_argv, str):
            args += extra_argv.split()
        elif extra_argv:
            args += list(extra_argv)
        return pytest.main(args + files) == 0
