"""Distribution over the ("data", "model") mesh: tensor parallelism of the
UNet (`tp.py`) and the multi-process rehearsal (`pod_rehearsal.py`)."""
