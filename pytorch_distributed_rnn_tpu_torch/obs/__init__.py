"""The pieces of the JAX package's ``obs/`` that serving reads: the
percentile convention (:mod:`.summary`), the rolling rate windows and
the request-latency histogram (:mod:`.live`), and the request trace
context (:mod:`.tracectx`).  The recorder, the live plane, the watchdog
and the exporter are not ported yet."""
