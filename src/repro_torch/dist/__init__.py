"""Decentralized runtime on node-stacked state.

  gossip       MATCHA mixing as per-matching gathers along the node dim,
               then the fused gossip-axpy update
  decen_train  stacked per-node state + the decentralized SGD train step
  serve        prefill / decode step builders for one serving replica
  fsdp         sharded replicas on the gossip bucket layout
  sharding     the logical-axis rules and the node and shard counts
  comm         every collective of the port, recorded, over a mesh group
"""
