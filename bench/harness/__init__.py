"""The benchmark's harness: the order of a run, spans, work counts, the
planted faults.

Everything here belongs to the yardstick: it reads a cell's files by name
(``bench/configs``, ``bench/traffic``, ``bench/cells``, and the modules
``bench/drivers``, ``bench/judges``, ``bench/metrics``), drives the
program (``repro_torch``) through its public facade, records spans from
outside it, and has the judge hold what the timed path returned to the
plain reference (``bench/reference``). It imports neither JAX nor the JAX
package.
"""
