"""Quality of service of the port: the fault-injection plane the
sidecars' and pools' seams register with (``qos.faults``) and the
circuit breaker around the merge sidecar's dispatch (``qos.breaker``),
copies of the reference's modules."""
from .breaker import BreakerOpenError, CircuitBreaker
from .faults import PLANE, FaultSchedule, InjectionSite, TransientFault

__all__ = ["BreakerOpenError", "CircuitBreaker", "FaultSchedule",
           "InjectionSite", "PLANE", "TransientFault"]
