"""Stage contracts, params, logging and the device plan."""
