"""Multi-process serving cluster (twin of ``repro/serving/cluster/``):
engine replica workers, a prefix-affinity router, and an HTTP/SSE
streaming frontend.

Topology:

    client --HTTP/SSE--> frontend --(in-proc)--> Router
                                       | NDJSON over localhost TCP
                            +----------+----------+
                            v                     v
                      worker 0 (subprocess)  worker 1 (subprocess)
                      ContinuousBatchingEngine each, on its own card

Replicas are pure data-parallel: workers never communicate with each
other, and each worker's engine is placed on a world of 1 of its own.
Determinism (``fold_in(seed, position)`` sampling keys, params from a
generator seeded with 0) makes any replica produce bit-identical tokens
for a request — cluster-vs-single-process parity is a hard assertion.

Import layering: this package root, ``protocol``, ``affinity``,
``router`` and ``frontend`` use no torch themselves.  The router and
frontend process imports torch through the parent package
(``repro_torch.serving``) but touches no CUDA device: it never builds a
mesh, allocates a tensor or loads params; only ``worker`` (lazily, inside
functions) and the subprocesses it runs touch devices.
"""
from repro_torch.serving.cluster.protocol import (ClusterError,
                                                  ConnectionClosed,
                                                  ProtocolError,
                                                  ReplicaDeadError,
                                                  SubmitRejectedError,
                                                  InProcTransport,
                                                  MessageStream,
                                                  encode_message)
from repro_torch.serving.cluster.affinity import PrefixAffinity
from repro_torch.serving.cluster.router import ReplicaHandle, Router
from repro_torch.serving.cluster.launcher import WorkerProcesses
from repro_torch.serving.cluster.frontend import ClusterHTTPServer

__all__ = [
    "ClusterError", "ConnectionClosed", "ProtocolError", "ReplicaDeadError",
    "SubmitRejectedError", "InProcTransport", "MessageStream",
    "encode_message", "PrefixAffinity", "ReplicaHandle", "Router",
    "WorkerProcesses", "ClusterHTTPServer",
]
