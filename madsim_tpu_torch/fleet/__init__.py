"""madsim_tpu_torch/fleet — the port's control-plane glue.

Today only `httpd.py`, the daemon glue `serve --service stats` runs on
(the port of `madsim_tpu/fleet/httpd.py`). The fleet worker backend
comes later (ROADMAP.md queue 1, item 11).
"""
