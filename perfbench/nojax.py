"""The check that a run loaded neither JAX nor the JAX package: module
names compared by their top-level part, whole (the port's own name,
``lammps_user_conp2_tpu_torch``, begins with the JAX package's)."""

FORBIDDEN = ("jax", "jaxlib", "flax", "lammps_user_conp2_tpu")


def jax_modules(names) -> list:
    """The names among ``names`` whose top-level part is forbidden."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)
