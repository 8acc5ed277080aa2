"""Index-build configurations the port serves (``msq_aids``)."""
