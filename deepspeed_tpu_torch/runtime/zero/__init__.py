"""The offload tiers of one device: ZeRO-Offload's host optimizer
(``offload.py``), ZeRO-Infinity's layer-streamed step (``infinity.py``)
and the offload wire codec (``wire_codec.py``)."""
