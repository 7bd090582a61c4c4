"""Fan-out-regular masked neighbour mean (the AGG of paper Eq. 1)."""
