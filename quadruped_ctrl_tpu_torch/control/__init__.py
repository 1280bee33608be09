"""The controller: command filter, swing, safety, leg torques, the control tick."""
