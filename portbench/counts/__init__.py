"""Operation and byte counts by site, from the cells' shapes, and the
card's peaks."""
