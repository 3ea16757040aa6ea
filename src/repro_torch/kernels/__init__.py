"""Hand-written Hopper kernels of the packed serving path, their plain
PyTorch versions, and the model-layer wrappers (``ops``). Importing this
package builds nothing; see ``build``."""
