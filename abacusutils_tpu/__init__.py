"""abacusutils-tpu: a JAX framework for AbacusSummit N-body data products.

Capability-parity rebuild of abacusorg/abacusutils with a JAX/XLA
compute engine: halo-catalog loading, HOD mock galaxy population, power
spectra, correlation functions, and Zel'dovich/linear control variates.
"""

__version__ = '0.1.0'
