"""Static checks of the port: ``synccheck``, the host-sync lint over the
dispatch loops (``python -m fluidframework_tpu_torch.analysis``)."""
from .synccheck import DISPATCH_LOOPS, RULES, Finding, check_package, \
    check_source

__all__ = ["DISPATCH_LOOPS", "Finding", "RULES", "check_package",
           "check_source"]
