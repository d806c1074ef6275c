"""Structured run telemetry, the port of the JAX package's ``obs/``.

- :mod:`.recorder`: the rank-tagged JSONL event stream, buffered off the
  training hot path (:class:`MetricsRecorder` / :data:`NULL_RECORDER`,
  which starts no thread); :mod:`.spans`: its duration events.
- :mod:`.profile`: ``--profile DIR`` and the step-bounded
  ``--profile-steps A:B`` capture over ``torch.profiler``.
- :mod:`.flops`: the analytic FLOP and byte count of a train step, run on
  the ``meta`` device under a dispatch mode (the ledger's MFU numerator).
- :mod:`.summary`: sidecar loading, summaries, diffs, stragglers,
  liveness; :mod:`.ledger`: the efficiency ledger (phase fractions,
  goodput, MFU against ``utils/hw.py``, fault tax, the regression gate);
  :mod:`.timeline`: clock alignment across ranks, the Chrome-trace
  export and its validator, phase attribution.
- :mod:`.live`: rolling windows, the request-latency histogram, the
  digest exporter and the per-process ``LivePlane`` (``--live``);
  :mod:`.aggregator`: rank 0's digest aggregation and HTTP server (``GET
  /metrics``, ``/health``, ``/events``, ``/fleet``); :mod:`.store`: its
  time series; :mod:`.watchdog`: stall, NaN streak and loss spike
  detection, and the SIGUSR2 stack dump.
- :mod:`.tracectx`: the request trace context of the serving wire;
  :mod:`.trace`: the router's and replicas' spans of a traced request
  joined into one tree across sidecars.
- :mod:`.cli`: ``python -m pytorch_distributed_rnn_tpu_torch.obs``.
"""

from pytorch_distributed_rnn_tpu_torch.obs.aggregator import (
    Aggregator,
    AggregatorServer,
    render_prometheus,
)
from pytorch_distributed_rnn_tpu_torch.obs.ledger import (
    FRACTION_TOL,
    LEDGER_PHASES,
    ledger_events,
    ledger_file,
    ledger_run,
)
from pytorch_distributed_rnn_tpu_torch.obs.live import (
    LIVE_ENV,
    LatencyHistogram,
    LiveExporter,
    LivePlane,
    RollingWindow,
)
from pytorch_distributed_rnn_tpu_torch.obs.profile import StepTraceCapture
from pytorch_distributed_rnn_tpu_torch.obs.recorder import (
    METRICS_ENV,
    NULL_RECORDER,
    SCHEMA_VERSION,
    MetricsRecorder,
    NullRecorder,
    rank_suffixed,
)
from pytorch_distributed_rnn_tpu_torch.obs.summary import (
    MalformedMetricsError,
    load_events,
    rank_files,
    rank_health,
    summarize_file,
)
from pytorch_distributed_rnn_tpu_torch.obs.timeline import (
    build_chrome_trace,
    load_run,
    validate_chrome_trace,
    write_chrome_trace,
)
from pytorch_distributed_rnn_tpu_torch.obs.tracectx import TraceContext, should_sample
from pytorch_distributed_rnn_tpu_torch.obs.watchdog import (
    AnomalyWatchdog,
    install_stack_dump_handler,
)

__all__ = [
    "Aggregator", "AggregatorServer", "AnomalyWatchdog", "FRACTION_TOL", "LEDGER_PHASES",
    "LIVE_ENV", "LatencyHistogram", "LiveExporter", "LivePlane", "METRICS_ENV",
    "MalformedMetricsError", "MetricsRecorder", "NULL_RECORDER", "NullRecorder",
    "RollingWindow", "SCHEMA_VERSION", "StepTraceCapture", "TraceContext",
    "build_chrome_trace", "install_stack_dump_handler", "ledger_events", "ledger_file",
    "ledger_run", "load_events", "load_run", "rank_files", "rank_health", "rank_suffixed",
    "render_prometheus", "should_sample", "summarize_file", "validate_chrome_trace",
    "write_chrome_trace",
]
