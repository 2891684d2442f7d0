"""The loma DSL on PyTorch (port of ``lomanerf_tpu.dsl``): the same front
end (parser, checks, type inference), lowered to eager PyTorch with
``torch.func`` autodiff (SURVEY.md §2.1)."""

from lomanerf_tpu_torch.dsl import ir  # noqa: F401
from lomanerf_tpu_torch.dsl.compiler import TorchLib, compile, make__dfloat  # noqa: F401
from lomanerf_tpu_torch.dsl.parser import parse  # noqa: F401
from lomanerf_tpu_torch.dsl.pretty_print import func_to_str  # noqa: F401
