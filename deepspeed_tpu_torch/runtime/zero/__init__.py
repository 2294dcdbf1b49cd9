"""ZeRO: the sharding policy over the data-parallel ranks
(``sharding.py``), the partitioned step's shards, gathers and stage 3's
per-layer gather (``partitioned.py``), ``TiledLinear`` (``tiling.py``);
and the offload tiers of one device: ZeRO-Offload's host optimizer
(``offload.py``), ZeRO-Infinity's layer-streamed step (``infinity.py``)
and the offload wire codec (``wire_codec.py``)."""
