"""One reader a per-layer metric, ``<metric>.py``, found by the metric's
name: ``read(stretch) -> float | None``. ``stretch`` describes the traced
stretch of a run (:func:`nerfbench.traffic.train.run`,
:func:`nerfbench.traffic.render.run`): ``kind``, ``units`` (steps or
frames traced), ``rays_per_unit``, ``flop_per_ray``, ``window_s``,
``busy_s``, ``device_ops`` ``[(name, seconds)]``, ``plain_units`` and
``plain_s`` (as many steps or frames just before, not traced) and, for
training, ``data_host_s``. A reader that finds nothing to read returns
None."""
