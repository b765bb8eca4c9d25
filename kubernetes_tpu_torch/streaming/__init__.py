"""Open-loop streaming subsystem: arrival processes, SLO-adaptive
batching, and priority-band backpressure.

Every closed-loop burst number answers "how fast can the drain go"; the
production question is "how much sustained arrival traffic fits under a
fixed p99 pod-to-bind budget". This package supplies the three parts
that turn the burst bench into that measurement:

- ``arrivals``:  seeded trace generators (Poisson, bursty/MMPP, diurnal
  ramp, replay-from-JSON) and a paced ``ArrivalEngine`` that feeds pods
  into the apiserver continuously, recording per-pod ``created_ts`` so
  pod-to-bind latency is end-to-end, with explicit backpressure (a
  bounded activeQ depth stalls the engine instead of growing the heap
  without bound).
- ``autobatch``: the ``AutoBatchController`` feedback loop that replaces
  the static ``batch_window``/``max_batch`` knobs -- latency mode when
  the queue is shallow, throughput mode when backlog builds, anchored to
  a configured p99 pod-to-bind SLO.
- priority-band queue jumping lives in
  ``kubernetes_tpu_torch/queue/scheduling_queue.py`` (``band_threshold``):
  high-priority pods never wait out a batch window behind a bulk drain.
"""

from kubernetes_tpu_torch.streaming.arrivals import (  # noqa: F401
    ArrivalEngine,
    bursty_trace,
    diurnal_trace,
    load_trace,
    poisson_trace,
    replay_trace,
    trace_from_config,
)
from kubernetes_tpu_torch.streaming.autobatch import (  # noqa: F401
    AutoBatchController,
)
