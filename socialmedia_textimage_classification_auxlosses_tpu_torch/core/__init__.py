"""Configuration shared by the port's entry points (``core/config.py``).

The JAX package's ``core/rng.py`` (``RngStreams``: named ``jax.random`` keys
folded from one root seed, beside a host ``np.random.RandomState``) has no
port, because its job is done elsewhere: ``cli/_common.py::seed_everything``
seeds Python, numpy and torch and returns the run's ``torch.Generator``, the
trainers draw the initialisation, dropout and the TIM swaps from explicit
``torch.Generator`` objects handed down to the builders and steps, and the
data order comes from ``np.random.RandomState(seed)`` as in the JAX package.
The draws differ from ``jax.random``'s; the tests carry JAX's initial
parameters across and run without dropout where they compare runs.
"""
