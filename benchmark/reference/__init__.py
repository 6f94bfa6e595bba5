"""The plain reference of the benchmark's cells: frozen copies of the port's
plain PyTorch code (no kernel, no import of the port, of JAX or of the JAX
package), which the comparison that decides ``correct`` holds the program's
outputs to."""
