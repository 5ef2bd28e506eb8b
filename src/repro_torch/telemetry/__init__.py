"""Device-side metrics (``metrics``) and host-side spans (``trace``)."""
from repro_torch.telemetry.trace import (Span, clear, export, profile, span,
                                         spans)

__all__ = ["Span", "clear", "export", "profile", "span", "spans"]
