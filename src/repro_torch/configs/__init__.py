"""Hardware configurations of the port's analytic model."""
