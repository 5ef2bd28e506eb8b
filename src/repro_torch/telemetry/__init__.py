"""Device-side metrics (``metrics``), host-side spans (``trace``) and the
unified report (``report``, the ``repro.telemetry/v1`` schema)."""
from repro_torch.telemetry.trace import (Span, clear, export, profile, span,
                                         spans)
from repro_torch.telemetry import report

__all__ = ["Span", "clear", "export", "profile", "report", "span", "spans"]
