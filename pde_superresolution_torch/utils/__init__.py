"""Host-side utilities: JSONL metrics and TensorBoard scalar events
(``metrics``, ``tb_events``), device traces and timing (``profiling``), and
numerical checks (``debugging``)."""

from pde_superresolution_torch.utils.metrics import MetricsLogger  # noqa: F401
