"""Client datasets: synthetic pools and Dirichlet client splits."""
