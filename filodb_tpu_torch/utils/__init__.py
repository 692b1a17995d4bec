"""Host utilities: the device upload ledger and flight recorder."""
