"""Drop-in import-compatibility package for `abacusnbody` (the reference
abacusutils namespace): every module re-exports the JAX
implementation from `abacusutils_tpu`, so existing user code and configs run
unchanged."""

from abacusutils_tpu import __version__  # noqa: F401
