"""Hand-written Hopper kernels with runtime-k noise slots and the
``pallas_region`` adapter onto the controller spine."""
