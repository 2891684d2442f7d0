"""Parity harness: the reference loma CPU implementation as a golden oracle
(the port's copy of ``lomanerf_tpu.parity``)."""

from lomanerf_tpu_torch.parity import oracle  # noqa: F401
from lomanerf_tpu_torch.parity.oracle import oracle_available  # noqa: F401
