"""One runner per kind of traffic.  A traffic file (``traffic/<mix>.json``)
names its runner and holds the runner's parameters.

A runner module defines ``Runner(config, traffic, seed, device,
system="port")`` with ``setup()`` (inputs, weights, warm-up of every shape
the traffic uses; its ``phases`` timed), ``run(seconds=None, count=None,
measured=True)`` (one closed-loop window; returns what the metric readers
read), ``e2e(window)`` (the end-to-end values it can give), ``release()``
(frees the port's state) and ``check()`` (the numbers that decide
``correct``, worked out by the plain reference after the window, and how
many answers were compared).  ``system="control"`` puts the reference at a
lower precision in the port's place.
"""
