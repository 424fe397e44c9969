"""Simulated infrastructure services (reference: madsim-etcd-client,
madsim-rdkafka, madsim-aws-sdk-s3).

Each service is ordinary application code on top of the fabric: a
`SimServer` node speaking a request protocol over `Endpoint.connect1`,
plus a client with the real service's API shape. All chaos (latency,
partitions, node kill/restart) applies to them like to any other node.
"""

from . import etcd, kafka, s3

__all__ = ["etcd", "kafka", "s3"]
