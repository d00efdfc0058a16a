"""State-dict conversion into the port's reference key layout, training
checkpoints (the port's torch ones, checkpoint/io.py), and the JAX
package's Orbax directories read and written without orbax or tensorstore
(checkpoint/orbax_io.py)."""
