"""Developer tools (counterpart of ``pyamg_tpu/_tools``)."""

from pyamg_tpu_torch._tools._tester import PytestTester

__all__ = ["PytestTester"]
