"""The port's share of the jmpi runtime: so far only the ``indexed``
datatype that the paged KV cache's block tables are expressed in."""
