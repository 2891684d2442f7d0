"""The DSL and data demos of the JAX package's ``examples/``, on the port:
Newton's method with DSL derivatives (``optimize_poly``), a pendulum and a
mass-spring system integrated with DSL Hamiltonian partials
(``single_pendulum``, ``mass_spring``), a differentiable sphere raytracer
(``diff_raytrace``) and a ray and dataset plot (``ray_visualization``).

Run one with ``python -m lomanerf_tpu_torch.examples.<name>`` (on the card;
``--device cpu`` for the CPU).  Each ``main(argv)`` returns what it
computed.
"""
