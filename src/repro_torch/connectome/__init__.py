"""The connectivity update: octree, Barnes-Hut search, routing, synapses."""
