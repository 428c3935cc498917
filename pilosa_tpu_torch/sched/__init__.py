"""Query admission control and QoS scheduling (the port of pilosa_tpu/sched).

Between the HTTP layer (server/api.py) and the executor: every query is
admitted before it may dispatch, weighted by its estimated device bytes
(cost.py), bounded by a concurrency cap, a deadline- and priority-aware
queue and an in-flight byte budget, and shed with HTTP 429 + Retry-After
when the queue is full or a deadline cannot be met (admission.py). Per
index limits come from tenants.py. The controller's load feeds the Count
batcher's adaptive hold (exec/batcher.py) and its queue peek the
prefetcher (hbm/prefetch.py).
"""

from pilosa_tpu_torch.sched.admission import (  # noqa: F401
    AdmissionController,
    CLASS_BATCH,
    CLASS_INTERACTIVE,
    CLASS_INTERNAL,
    CLASS_WEIGHTS,
    DEADLINE_HEADER,
    PRIORITY_HEADER,
    ShedError,
    Ticket,
)
from pilosa_tpu_torch.sched.cost import QueryCost, ZERO_COST, estimate  # noqa: F401
