"""Inference serving of the port: ``InferenceServer`` (frontend: the ZMQ
ROUTER, the wire-v3 codec, the compute loop) -> ``DynamicBatcher``
(batcher: coalescing, the bucket ladder, admission control) ->
``ModelRunner`` (model: the frozen forward, snapshot swap and rollback);
``InferenceClient`` (client) is the DEALER peer; ``ReplicaBalancer``
(balancer) serves a fleet of replicas that ``--announce`` into it.

Config home: ``root.common.serving.{max_batch, max_delay_ms, queue_bound,
request_ttl_s, max_requests}`` + ``root.common.serving.admission.*`` +
``root.common.serving.mesh.{data,model}`` +
``root.common.serving.balance.*``; CLI: ``python -m znicz_torch <sample>
--serve [BIND] --snapshot FILE [--announce EP]`` and ``python -m
znicz_torch --balance [BIND]``.  The seeded chaos harness
(``FaultSchedule``, ``ChaosProxy``, ``FloodProcess``, and the fleet's
``ReplicaHarness``, ``ScriptedReplica``, ``FleetScaler``) is
``znicz_torch.parallel.chaos``.
"""

from .balancer import ReplicaBalancer                       # noqa: F401
from .batcher import (AdmissionPolicy, BucketLadder,        # noqa: F401
                      DynamicBatcher, Refusal, Request, TokenBucket)
from .client import (CircuitOpenError, InferenceClient,     # noqa: F401
                     InferenceError)
from .frontend import InferenceServer                       # noqa: F401
from .model import ModelRunner                              # noqa: F401
