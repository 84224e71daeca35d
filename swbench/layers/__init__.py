"""One reader a per-layer metric, found by the metric's name.

A reader module declares what it reads and how:

- ``SPANS``: {span name: [targets]}, each target ``"module:attr"`` or
  ``"module:Class.attr"`` of the system under test, wrapped from outside;
- ``SPAN_VALUES``: {span name: function(args, kwargs, result)} for spans
  that keep a value of each call;
- ``ENTRIES``: the kernel library's C entries it reads (``"*"``: all); a
  traced run brackets every launching entry, so this declares, it does
  not select;
- ``read(trace)``: the metric's value from a closed
  :class:`swbench.trace.Trace`; None where it finds nothing to read, which
  makes a traced run on a card incorrect; ``swbench.spec.ABSENT`` where
  the program under test has no span, counter or kernel of the kind it
  reads (a parent older than the reader), which leaves the metric out.
"""
