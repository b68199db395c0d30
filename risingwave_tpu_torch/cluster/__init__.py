"""The cluster layer of the port.

Only the vnode scale plane (``cluster.scale``) is ported: the engine-level
API a compute worker calls (``Engine.partition_job``,
``Engine.set_job_vnodes``, ``Engine.repartition_job``) with the pure map
functions a meta uses.  The reference's RPC, meta service and worker
processes are not ported.
"""
