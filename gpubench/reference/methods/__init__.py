"""The reference of each of sid's methods, one file a method
(``<method>.py``, its ``expected``), found by the method's name."""
